// The kernel-function epilogue shared by the fused Gram kernel (K1,
// gram.cu) and the fused Gram x V kernel (K3, gram_matvec.cu): g(d2) for
// the six kinds, or the plain inner product for the linear kind. Both
// kernels compute d2 = |x|^2 + |y|^2 - 2 x.y with one FMA chain for the
// norms and the inner product, so d2 is exactly 0 where x is y. Also
// g'(d2), shared by the two gradient kernels: K1's backward (gram_bwd.cuh)
// and K3's (gram_matvec_vjp.cuh).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace stheno {

enum Kind { kEq = 0, kRq = 1, kMatern12 = 2, kMatern32 = 3, kMatern52 = 4, kLinear = 5 };

__device__ __forceinline__ float dev_exp(float v) { return expf(v); }
__device__ __forceinline__ double dev_exp(double v) { return exp(v); }
__device__ __forceinline__ float dev_sqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dev_sqrt(double v) { return sqrt(v); }
__device__ __forceinline__ float dev_pow(float a, float b) { return powf(a, b); }
__device__ __forceinline__ double dev_pow(double a, double b) { return pow(a, b); }
__device__ __forceinline__ float dev_log(float v) { return logf(v); }
__device__ __forceinline__ double dev_log(double v) { return log(v); }

template <int KIND, typename T>
__device__ __forceinline__ T epilogue(T d2, T inner, T alpha) {
  if (KIND == kLinear) return inner;
  d2 = d2 > T(0) ? d2 : T(0);
  if (KIND == kEq) return dev_exp(T(-0.5) * d2);
  if (KIND == kRq) return dev_pow(T(1) + d2 / (T(2) * alpha), -alpha);
  const T d = dev_sqrt(d2 + T(1e-36));
  if (KIND == kMatern12) return dev_exp(-d);
  if (KIND == kMatern32) {
    const T r = T(1.7320508075688772) * d;
    return (T(1) + r) * dev_exp(-r);
  }
  const T r = T(2.23606797749979) * d;  // matern52
  return (T(1) + r + r * r / T(3)) * dev_exp(-r);
}

// dK/d(d2) of the five distance kinds at d2 >= 0, the arithmetic of
// ops/gram.py:_g_prime. *k receives the entry K itself (the epilogue
// above), from the same exp: for eq K = -2 g', the other kinds add their
// polynomial factor. For rq, *h also receives K (d2 / (2 alpha base) -
// log base), the entry's factor of dK/d(alpha); `hia` is 1 / (2 alpha).
template <int KIND, typename T>
__device__ __forceinline__ T g_prime(T d2, T alpha, T hia, T* k, T* h) {
  if (KIND == kEq) {
    *k = dev_exp(T(-0.5) * d2);
    return T(-0.5) * *k;
  }
  if (KIND == kRq) {
    const T base = T(1) + d2 * hia;
    const T lb = dev_log(base);
    *k = dev_exp(-alpha * lb);
    const T ib = T(1) / base;
    *h = *k * (d2 * hia * ib - lb);
    return T(-0.5) * *k * ib;
  }
  const T d = dev_sqrt(d2 + T(1e-36));
  if (KIND == kMatern12) {
    *k = dev_exp(-d);
    return T(-0.5) * *k / d;
  }
  if (KIND == kMatern32) {
    const T r = T(1.7320508075688772) * d;
    const T e = dev_exp(-r);
    *k = (T(1) + r) * e;
    return T(-1.5) * e;
  }
  const T r = T(2.23606797749979) * d;  // matern52
  const T e = dev_exp(-r);
  *k = (T(1) + r + r * r / T(3)) * e;
  return T(-5.0 / 6.0) * (T(1) + r) * e;
}

// The second-order terms of the five distance kinds at d2 >= 0, the
// arithmetic of ops/gram.py:_g_second and _alpha_second, for the forward
// rule of K1's backward (gram_bwd_jvp.cu): *gp receives g'(d2) (as
// g_prime), the return value is g''(d2) = d^2 K / d(d2)^2. For rq, *h
// receives dK/dalpha (as g_prime), *gpa the mixed d g' / d alpha and *haa
// d^2 K / d alpha^2; the other kinds leave them alone. With d = sqrt(d2 +
// 1e-36), Matérn-1/2's g'' is K (1 + d) / (4 d^3) and Matérn-3/2's 9 e /
// (4 r): at d2 = 0 (coincident points) the first overflows float32 and
// the second is 1e18 times larger than anywhere else; the kernel never
// multiplies them by a d2 tangent of 0 (see gram_bwd_jvp.cu).
template <int KIND, typename T>
__device__ __forceinline__ T g_second(T d2, T alpha, T hia, T* gp, T* h, T* gpa, T* haa) {
  T k;
  *gp = g_prime<KIND, T>(d2, alpha, hia, &k, h);
  if (KIND == kEq) return T(0.25) * k;
  if (KIND == kRq) {
    const T base = T(1) + d2 * hia;
    const T ib = T(1) / base;
    const T u = d2 * hia * ib;  // d2 / (2 alpha base)
    const T q = u - dev_log(base);  // h = K q
    const T ia = T(1) / alpha;
    *gpa = *gp * (q + u * ia);
    *haa = k * (q * q + u * u * ia);
    return T(0.25) * (T(1) + ia) * k * ib * ib;
  }
  const T d = dev_sqrt(d2 + T(1e-36));
  if (KIND == kMatern12) return T(0.25) * k * (T(1) + d) / (d * d * d);
  if (KIND == kMatern32) {
    const T r = T(1.7320508075688772) * d;
    return T(2.25) * dev_exp(-r) / r;
  }
  return T(25.0 / 12.0) * dev_exp(T(-2.23606797749979) * d);  // matern52
}

}  // namespace stheno
