// The division form of the symmetric per-tensor int8 quantize,
//
//   q = clip(rint(fl(x / s)), -127, 127)        (rint: half to even)
//
// with no division per element: the float-resident int8 tier's activation
// quantize (tensorrtx_tpu/ops/nn.py:98), shared by the standalone kernel
// (quantize.cu) and the int8 1x1 that quantizes its float input while it
// stages it (qconv.cu). An IEEE division (__fdiv_rn) is an FCHK and a call
// to a slow path that nothing is scheduled across; even on a branch that is
// rarely taken, the call cost the tier's 1x1 convs a tenth of their time
// (measured on the H100).
//
// The scale. When |s| < 2^-100 (or > 2^100), x and s are scaled by k = 2^64
// (2^-64) first (exact, where it matters: a product that leaves the float
// range belongs to a quotient that clips, or rounds to 0), so that 1 / (k s)
// is a normal float and the multiples below stay above the subnormal grid;
// the guesses do not scale (a multiply an element), so at such scales every
// value takes the exact path. Below, x and s stand for k x and k s.
//
// The guess. With r = fl(1 / s) taken once a launch, v = fl(x * r) lies
// within about 1.5 * 2^-23 |x / s| of fl(x / s), so the two round to the same
// integer unless a half-integer lies that close to v. v is clipped first
// (rint and the clip commute: +-127 are integers; |x * r| > 127 means
// |x / s| > 126.5, which clips to the same sign), so |v| <= 127, and every v
// within 2^-13 of a half-integer (|v - rint(v)| >= 0.5 - 2^-13; exact
// arithmetic there) goes to the exact path: 2^-13 >= 8 * 2^-23 * 127, a margin
// of five. When s is a power of two with a normal reciprocal, x * r and x / s
// are the same real number, rounded once each: v is fl(x / s) and no guard
// is needed. rint is one add of 1.5 * 2^23 (round to nearest even, exact for
// |v| < 2^22), whose low mantissa byte is then q as a two's-complement byte.
// NaN gives -127 in both forms.
//
// The exact path, for v within 2^-13 of the half-integer h (so x / s lies
// within about 2^-12 of h): c = x - h * s by one FMA is exact (x and h * s
// are multiples of ulp(s) / 2 and c is under 2^13 of them). fl(x / s) is h
// when |c| < ulp(h) / 2 * |s| (or equal to
// it, with h's last mantissa bit even: the float rounding's tie), and then q
// is rint(h), the even neighbour; otherwise fl(x / s) lies beyond h on the
// side of c / s, and q is h +- 1/2.
//
// `quantize_int8_div_free` in ops/cuda/quantize.py is the same arithmetic in
// torch ops (c in float64, where it is exact too); the tests hold it equal
// to the division form for every finite bf16 value at hundreds of scales and
// on float32 values built on half-integers, and chip_smoke.py holds the
// kernels to the division form on the card.

#pragma once

#include <stdint.h>

struct DivQuant {
  float k;     // 2^64 when |s| < 2^-100, 2^-64 when |s| > 2^100, else 1
  float ks;    // k * s
  float r;     // fl(1 / (k * s))
  bool exact;   // k * s = +-2^e: fl(x * r) == fl(x / s)
  bool scaled;  // k != 1: the guesses (unscaled) do not hold; every value takes the exact path
};

__device__ __forceinline__ DivQuant div_quant(float s) {
  const float a = fabsf(s);
  const float k = a < 7.888609052210118e-31f   ? 1.8446744073709552e19f   // 2^-100, 2^64
                  : a > 1.2676506002282294e30f ? 5.421010862427522e-20f   // 2^100, 2^-64
                                               : 1.0f;
  const float ks = __fmul_rn(k, s);
  const uint32_t b = __float_as_uint(ks);
  return DivQuant{k, ks, __fdiv_rn(1.0f, ks), (b & 0x7fffffu) == 0 && ((b >> 23) & 0xffu) != 0,
                  k != 1.0f};
}

constexpr float kRintMagic = 12582912.0f;       // 1.5 * 2^23
constexpr float kNearHalf = 0.4998779296875f;   // 0.5 - 2^-13

// q's bits from x * (1/s), unscaled: the low byte of the result is q unless
// `dist` = |v - rint(v)| is at least kNearHalf (v near a half-integer) or
// q.scaled, in which case the caller takes quantize_div_bits (which scales).
__device__ __forceinline__ uint32_t quantize_div_guess(float x, const DivQuant& q, float& dist) {
  const float v = fminf(fmaxf(__fmul_rn(x, q.r), -127.0f), 127.0f);
  const float t = __fadd_rn(v, kRintMagic);
  dist = fabsf(__fsub_rn(v, __fsub_rn(t, kRintMagic)));
  return __float_as_uint(t);
}

// clip(rint(fl(x / s)), -127, 127) in the low byte of the result, bit for bit.
__device__ __forceinline__ uint32_t quantize_div_bits(float x, const DivQuant& q) {
  const float xk = __fmul_rn(x, q.k);
  const float v = fminf(fmaxf(__fmul_rn(xk, q.r), -127.0f), 127.0f);
  const float t = __fadd_rn(v, kRintMagic);
  const float n = __fsub_rn(t, kRintMagic);
  const float d = __fsub_rn(v, n);
  if (fabsf(d) < kNearHalf || q.exact) return __float_as_uint(t);
  const float h = __fadd_rn(n, copysignf(0.5f, d));       // the half-integer v is near
  const float c = __fmaf_rn(-h, q.ks, xk);  // k (x - h s), exactly
  const uint32_t hb = __float_as_uint(h);
  const float half_ulp = __uint_as_float((((hb >> 23) & 0xffu) - 24u) << 23);
  const float lim = __fmul_rn(half_ulp, fabsf(q.ks));
  const float ac = fabsf(c);
  float y;
  if (ac < lim || (ac == lim && (hb & 1u) == 0)) {
    y = rintf(h);  // fl(x / s) == h
  } else {
    y = (c > 0.0f) == (q.ks > 0.0f) ? __fadd_rn(h, 0.5f) : __fsub_rn(h, 0.5f);
  }
  return __float_as_uint(__fadd_rn(fminf(fmaxf(y, -127.0f), 127.0f), kRintMagic));
}

// The guesses of N values in b; returns whether one of them lies near a
// half-integer, in which case the caller writes all N again by
// quantize_div_s8. Callers keep that pass out of their unrolled code (a
// rolled loop over bytes already stored): its weight in the hot loop, even
// untaken, cost the 1x1 convs a tenth of their time (measured on the H100).
template <int N>
__device__ __forceinline__ bool quantize_div_guesses(const float (&x)[N], const DivQuant& q,
                                                     uint32_t (&b)[N]) {
  float far = 0.0f, d;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    b[k] = quantize_div_guess(x[k], q, d);
    far = fmaxf(far, d);
  }
  return __builtin_expect((far >= kNearHalf && !q.exact) || q.scaled, 0);
}

__device__ __forceinline__ int8_t quantize_div_s8(float x, const DivQuant& q) {
  return static_cast<int8_t>(quantize_div_bits(x, q) & 0xffu);
}

// Four results' low bytes packed into one word, first in the lowest byte.
__device__ __forceinline__ uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c,
                                                   uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040), 0x5410);
}
