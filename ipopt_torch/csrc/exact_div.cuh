// Exact scalar arithmetic shared by the hand-written kernels K1
// (block_ldlt.cu) and K2 (block_ldlt_inv.cu): the reference's tiny-pivot
// guard, round-to-nearest operations that are never contracted into an FMA,
// and quotients a / p rounded to nearest from one reciprocal of p (an
// estimate, recip_estimate, is enough): a certified Markstein correction for
// p in Exact's range (div_by), and an exact reciprocal when p is a power of
// two (Pow2), as the guard's +-tiny pivots are.  What either cannot vouch for takes the library division.
#pragma once

#include <cuda_runtime.h>
#include <cfloat>

namespace {

template <typename T> struct Tiny;
template <> struct Tiny<float> {
  __device__ static float value() { return FLT_MIN; }
};
template <> struct Tiny<double> {
  __device__ static double value() { return DBL_MIN; }
};

// jnp.where(|p| > tiny, p, jnp.where(p >= 0, tiny, -tiny)); NaN -> -tiny.
template <typename T>
__device__ __forceinline__ T safe_pivot(T p) {
  const T tiny = Tiny<T>::value();
  const T ap = p < T(0) ? -p : p;
  return ap > tiny ? p : (p >= T(0) ? tiny : -tiny);
}

// Round-to-nearest arithmetic that the compiler never contracts into an FMA.
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }
__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }

// The ranges in which div_by's arithmetic neither under- nor overflows:
// |a| in [lo, hi] (or a = 0) and the divisor in [plo, phi], so the quotient
// lies in [lo / phi, hi / plo] and every residual is exact.
template <typename T> struct Exact;
template <> struct Exact<double> {
  static constexpr double lo = 0x1p-800, hi = 0x1p800, plo = 0x1p-100, phi = 0x1p100;
  static __device__ __forceinline__ bool rn(double q, double r, double b) {
    // 1/2 ulp(q) from its exponent; 1/4 ulp toward zero from a power of two
    const long long bits = __double_as_longlong(q);
    const long long ex = (bits >> 52) & 0x7ff;
    const bool pow2 = (bits & 0xfffffffffffffLL) == 0;
    const bool down = ((r < 0.0) != (b < 0.0)) != (q < 0.0);
    const double h = __longlong_as_double((ex - 53 - (pow2 & down)) << 52);
    return fabs(r) < fabs(b) * h;
  }
};
template <> struct Exact<float> {
  static constexpr float lo = 0x1p-50f, hi = 0x1p50f, plo = 0x1p-30f, phi = 0x1p30f;
  static __device__ __forceinline__ bool rn(float q, float r, float b) {
    const int bits = __float_as_int(q);
    const int ex = (bits >> 23) & 0xff;
    const bool pow2 = (bits & 0x7fffff) == 0;
    const bool down = ((r < 0.0f) != (b < 0.0f)) != (q < 0.0f);
    const float h = __int_as_float((ex - 24 - (pow2 & down)) << 23);
    return fabsf(r) < fabsf(b) * h;
  }
};

// a / b rounded to nearest, from y = RN(1 / b) or an estimate of it within
// about an ulp (recip_estimate), without a division:
// q = RN(a y), then q' = RN(q + (a - b q) y) (Markstein's correction; each
// residual a - b q is exact in one FMA).  q' is kept only when it is
// certified: a / b - q' = r' / b with r' = a - b q' exact, and q' is the
// rounded quotient iff |r'| < |b| h, h half the gap from q' to its
// neighbour on the side of a / b (ties cannot occur).  Otherwise, and
// outside Exact's ranges, ok turns false and the caller divides with div_rn.
// No branch: the four quotients of a thread overlap.
template <typename T>
__device__ __forceinline__ T div_by(T a, T b, T y, bool& ok) {
  const T q = mul_rn(a, y);
  const T q1 = fma(fma(-b, q, a), y, q);
  const T aa = fabs(a);
  const bool zero = a == T(0);
  const bool in = (aa >= Exact<T>::lo) & (aa <= Exact<T>::hi);
  ok &= zero | (in & Exact<T>::rn(q1, fma(-b, q1, a), b));
  return zero ? q : q1;
}

// An estimate of 1 / s within about an ulp: two Newton steps from the
// hardware's approximation.  It need not be correctly rounded: the
// certificate checks every quotient exactly.
__device__ __forceinline__ double recip_estimate(double s) {
  double y;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(s));
  double e = fma(-s, y, 1.0);
  y = fma(y, e, y);
  e = fma(-s, y, 1.0);
  return fma(y, e, y);
}
__device__ __forceinline__ float recip_estimate(float s) { return __frcp_rn(s); }

// Normal powers of two whose reciprocal is normal too: 1 / s is exact.
template <typename T> struct Pow2;
template <> struct Pow2<double> {
  static __device__ __forceinline__ bool is(double s) {
    const long long u = __double_as_longlong(s), e = (u >> 52) & 0x7ff;
    return (u & 0xfffffffffffffLL) == 0 && e >= 1 && e <= 2045;
  }
  static __device__ __forceinline__ double recip(double s) {
    const long long e = (__double_as_longlong(s) >> 52) & 0x7ff;
    return copysign(__longlong_as_double((2046 - e) << 52), s);
  }
};
template <> struct Pow2<float> {
  static __device__ __forceinline__ bool is(float s) {
    const int u = __float_as_int(s), e = (u >> 23) & 0xff;
    return (u & 0x7fffff) == 0 && e >= 1 && e <= 253;
  }
  static __device__ __forceinline__ float recip(float s) {
    const int e = (__float_as_int(s) >> 23) & 0xff;
    return copysignf(__int_as_float((254 - e) << 23), s);
  }
};

}  // namespace
