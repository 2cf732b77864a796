// One hop of the loopback BFP ring reduce-scatter, with the fused ZeRO-1
// optimizer update on the final hop.
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
// i+1, which adds it into its chunk (i-h-2) % n.  A chunk a rank receives
// at hop h is the chunk it sends at hop h+1, so launch k (k = 1..n-1) fuses
// "decode the hop k-1 frame + add it to x" with "encode that sum as the hop
// k frame into rank i+1's receive slot"; launch 0 has no arriving frame and
// encodes x's chunk (i-1) % n as it is.  Partial sums never go back to
// memory: each chunk of a rank is summed exactly once, so x stays
// read-only.  Frames live in two receive slots per rank (hop parity):
// within a launch rank i reads its own slot (k-1)%2 and writes slot k%2 of
// rank i+1, so no two threads touch one byte.  The final launch (k = n-1)
// lands on the rank's own chunk i,
// writes the reduced sum, and with an optimizer updates the master shard:
//   g = sum / n;  sgd: w' = fmaf(-lr, fmaf(wd, w, g), w)
// and the momentum / adamw forms of optim.fused_apply_blocks, each
// contraction site an explicit __fmaf_rn (sources build with -fmad=false).
//
// What bounds it on the card: bytes.  Per element and hop it does a few
// integer and float operations against 4 bytes of x and 2 x (1 + 1/B)
// bytes of frames.  The design reads x once in all (the TPU kernels copy it
// into an accumulator first), keeps the hop's sum in registers between the
// decode and the encode, and uses float4 / char4 accesses, one thread per
// four lanes of a tile.  Hops are separate launches on one stream: the
// launch boundary is the ring's barrier.  Frames still cross device memory
// once per hop, which is the wire of the loopback ring.
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
  const signed char* fm_in;       // [n, C]   arriving frames (null: hop 0)
  const signed char* fs_in;       // [n, C/B] scales of the arriving frames
  signed char* fm_out;            // [n, C]   next hop's frames (null: final)
  signed char* fs_out;            // [n, C/B]
  float* g_out;                   // [n, C]   reduced sums (final hop)
  const float* w;                 // [n, C]   master shards (optimizer only)
  float* w_out;
  const float* m_in;              // [n, C]   momentum / first moment
  float* m_out;
  const float* v_in;              // [n, C]   second moment
  float* v_out;
  const float* hyper;             // f32[8]
  int n;
  long long C;
  int k;                          // launch index, 0..n-1
  int mant_bits;
  int rtz;
  int opt_kind;
};

template <int B>
__global__ void __launch_bounds__(THREADS) ring_rs_hop_kernel(RsArgs a) {
  const long long per_rank = a.C / (4LL * B);
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= per_rank * a.n) return;
  const int i = (int)(gid / per_rank);
  const long long rem = gid % per_rank;
  const long long t = rem / QUADS;
  const int q = (int)(rem % QUADS);
  const long long off = t * (long long)(B * LANES) + 4 * q;  // in the chunk
  const long long soff = t * LANES + 4 * q;                  // its scales
  const long long sC = a.C / B;
  const int c = ((i - a.k - 1) % a.n + a.n) % a.n;         // chunk summed
  const float* xs = a.x + (long long)i * a.n * a.C + (long long)c * a.C + off;

  float4 v[B];
#pragma unroll
  for (int r = 0; r < B; ++r)
    v[r] = *reinterpret_cast<const float4*>(xs + r * LANES);
  if (a.fm_in != nullptr) {        // add the frame that arrived at hop k-1
    const signed char* fm = a.fm_in + (long long)i * a.C + off;
    const char4 s_in =
        *reinterpret_cast<const char4*>(a.fs_in + i * sC + soff);
#pragma unroll
    for (int r = 0; r < B; ++r) {
      const char4 m = *reinterpret_cast<const char4*>(fm + r * LANES);
      v[r] = add4(v[r], decode4(m, s_in));
    }
  }

  if (a.fm_out != nullptr) {       // forward the partial sum as hop k
    char4 m[B];
    char4 s;
    encode_quad<B>(v, a.mant_bits, a.rtz, m, s);
    const int dst = (i + 1) % a.n;
    signed char* om = a.fm_out + (long long)dst * a.C + off;
#pragma unroll
    for (int r = 0; r < B; ++r)
      *reinterpret_cast<char4*>(om + r * LANES) = m[r];
    *reinterpret_cast<char4*>(a.fs_out + dst * sC + soff) = s;
    return;
  }

  // final hop: c == i, the rank's own chunk
  const long long own = (long long)i * a.C + off;
#pragma unroll
  for (int r = 0; r < B; ++r)
    *reinterpret_cast<float4*>(a.g_out + own + r * LANES) = v[r];
  if (a.opt_kind == OPT_NONE) return;
  const float nf = (float)a.n;
#pragma unroll
  for (int r = 0; r < B; ++r) {
    const long long e = own + r * LANES;
    const float g[4] = {v[r].x / nf, v[r].y / nf,
                        v[r].z / nf, v[r].w / nf};
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
    for (int j = 0; j < 4; ++j)
      fused_update(a.opt_kind, a.hyper, g[j], w[j], m[j], vv[j], w2[j],
                   m2[j], v2[j]);
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

// One launch = hop k of every rank.  fm_in == null marks hop 0, fm_out ==
// null the final hop.
extern "C" int ring_rs_hop_launch(
    const float* x, const signed char* fm_in, const signed char* fs_in,
    signed char* fm_out, signed char* fs_out, float* g_out, const float* w,
    float* w_out, const float* m_in, float* m_out, const float* v_in,
    float* v_out, const float* hyper, int n, long long C, int k,
    int block_size, int mant_bits, int rtz, int opt_kind,
    cudaStream_t stream) {
  const RsArgs a{x, fm_in, fs_in, fm_out, fs_out, g_out, w, w_out, m_in,
                 m_out, v_in, v_out, hyper, n, C, k, mant_bits, rtz,
                 opt_kind};
  const long long n_threads = (long long)n * (C / (4LL * block_size));
#define HOP(BS) \
  ring_rs_hop_kernel<BS><<<grid_for(n_threads), THREADS, 0, stream>>>(a)
  BFP_DISPATCH_BLOCK(block_size, HOP)
#undef HOP
  return (int)cudaGetLastError();
}
