// Native host-side BFP codec — the port's copy of the JAX package's
// csrc/bfp_codec.cpp, bit-for-bit identical to the golden model
// (ops/bfp_golden.py), the repo's codec spec.
//
// Role: checkpoint (de)compression off the hot path (utils/checkpoint.py)
// and an independent parity check of the golden model in tests.
//
// Build: at first use by runtime/native.py (g++ -O3 -std=c++17 -pthread
// -shared -fPIC, no -fopenmp: one thread a call).
// ABI: plain C, loaded via ctypes (runtime/native.py).

#include <cmath>
#include <cstdint>
#include <cstring>

namespace {

inline int32_t biased_exp(float v) {
  uint32_t bits;
  std::memcpy(&bits, &v, sizeof(bits));
  return static_cast<int32_t>((bits >> 23) & 0xFF);
}

inline int32_t clampi(int32_t v, int32_t lo, int32_t hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

}  // namespace

extern "C" {

// rounding: 0 = nearest-even (rintf), 1 = truncate toward zero (rtz).
// n must be a multiple of block. mant: n int8; scale: n/block int8.
void bfp_encode_f32(const float* x, int64_t n, int32_t block,
                    int32_t mant_bits, int32_t rounding, int8_t* mant,
                    int8_t* scale) {
  const float lim = static_cast<float>((1 << (mant_bits - 1)) - 1);
  const int64_t nblocks = n / block;
  for (int64_t b = 0; b < nblocks; ++b) {
    const float* xb = x + b * block;
    int32_t emax = 0;
    for (int32_t i = 0; i < block; ++i) {
      int32_t e = biased_exp(xb[i]);
      if (e > emax) emax = e;
    }
    // [-126, 126]: both 2^s and 2^-s stay normal fp32 (see bfp_golden.py)
    int32_t scale_exp = clampi(emax - 127 - (mant_bits - 2), -126, 126);
    const float inv_scale = std::ldexp(1.0f, -scale_exp);
    for (int32_t i = 0; i < block; ++i) {
      float q = xb[i] * inv_scale;
      q = rounding == 0 ? std::rint(q) : std::trunc(q);
      if (q > lim) q = lim;
      if (q < -lim) q = -lim;
      mant[b * block + i] = static_cast<int8_t>(q);
    }
    scale[b] = static_cast<int8_t>(scale_exp);
  }
}

void bfp_decode_f32(const int8_t* mant, const int8_t* scale, int64_t n,
                    int32_t block, float* out) {
  const int64_t nblocks = n / block;
  for (int64_t b = 0; b < nblocks; ++b) {
    const float s = std::ldexp(1.0f, static_cast<int32_t>(scale[b]));
    for (int32_t i = 0; i < block; ++i) {
      out[b * block + i] = static_cast<float>(mant[b * block + i]) * s;
    }
  }
}

}  // extern "C"
