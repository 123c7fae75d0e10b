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

}  // namespace stheno
