// The fused ZeRO-1 optimizer update of the ring kernels, shared by the
// loopback reduce-scatter (ring_rs.cu) and the cross-process hop
// (ring_hop.cu), so the owner's update has the same bits in both.
//
// Bit spec: optim.golden_fused_apply (optim.fused_apply_blocks), each
// contraction site an explicit __fmaf_rn (the sources build with
// -fmad=false, so the compiler contracts nothing else); the gradient is
// the reduced sum divided by n in f32 before the call, as both callers do.
#pragma once

#include <cuda_runtime.h>

#include "bfp.cuh"

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

// The owner's update of one quad (4 lanes x B rows of a (B, 128) tile) at
// element e0 of its shards: v holds the reduced sums, g = v / n.  A null
// m_in / v_in reads 0 (the optimizers without that state).
template <int B>
__device__ __forceinline__ void update_quad(
    int kind, const float* hyper, int n, const float4 (&v)[B],
    const float* w_in, float* w_out, const float* m_in, float* m_out,
    const float* v_in, float* v_out, long long e0) {
  const float nf = (float)n;
#pragma unroll
  for (int k = 0; k < B; ++k) {
    const long long e = e0 + k * bfp::LANES;
    const float g[4] = {v[k].x / nf, v[k].y / nf,
                        v[k].z / nf, v[k].w / nf};
    const float4 w4 = *reinterpret_cast<const float4*>(w_in + e);
    const float w[4] = {w4.x, w4.y, w4.z, w4.w};
    float m[4] = {0.f, 0.f, 0.f, 0.f}, vv[4] = {0.f, 0.f, 0.f, 0.f};
    if (m_in != nullptr) {
      const float4 m4 = *reinterpret_cast<const float4*>(m_in + e);
      m[0] = m4.x; m[1] = m4.y; m[2] = m4.z; m[3] = m4.w;
    }
    if (v_in != nullptr) {
      const float4 v4 = *reinterpret_cast<const float4*>(v_in + e);
      vv[0] = v4.x; vv[1] = v4.y; vv[2] = v4.z; vv[3] = v4.w;
    }
    float w2[4], m2[4], v2[4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
      fused_update(kind, hyper, g[q], w[q], m[q], vv[q], w2[q], m2[q], v2[q]);
    *reinterpret_cast<float4*>(w_out + e) =
        make_float4(w2[0], w2[1], w2[2], w2[3]);
    if (m_out != nullptr)
      *reinterpret_cast<float4*>(m_out + e) =
          make_float4(m2[0], m2[1], m2[2], m2[3]);
    if (v_out != nullptr)
      *reinterpret_cast<float4*>(v_out + e) =
          make_float4(v2[0], v2[1], v2[2], v2[3]);
  }
}
