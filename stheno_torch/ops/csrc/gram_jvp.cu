// Forward-mode (tangent) kernel of the fused Gram K1 for Hopper, sm_90a.
//
// K1's forward rule. It replaces no Pallas kernel of its own: on the TPU
// the JAX package's forward mode differentiates the XLA Gram
// (stheno_tpu/ops/gram.py:_xla_gram), since the custom VJP around K1
// (_gram_kernel) has no forward rule. The port needs a kernel because
// K1 is a ctypes launch, which carries no tangents. For B tangent
// directions it computes, in one launch,
//   out[b, i, j] = 2 g'(d2_ij) <x_i - y_j, xt[b, i] - yt[b, j]>
//                  + dK/dalpha_ij at[b]                 (rq only),
//   out[b, i, j] = <xt[b, i], y_j> + <x_i, yt[b, j]>     (linear),
// with d2 = |x_i|^2 + |y_j|^2 - 2 x_i.y_j clamped at 0 by K1's own FMA
// chain, so the tangent is taken where K1 evaluated g; where the clamp
// bites (d2 < 0, rounding) the entry is flat and its d2 term is 0.
// g' and rq's dK/dalpha come from gram_kind.cuh's g_prime, K1's
// backward's epilogue. xt or yt may be null (no tangent), and at too.
// float32 and float64, row-major x (n, d), y (m, d), xt (B, n, d), yt
// (B, m, d), out (B, n, m).
//
// What bounds it: the B (n, m) output tiles written (at the flagship's
// 2000 x 2000, B = 3, float32: 48 MB, about 14 us at 3.35 TB/s); the
// depth d is a few. So the design is K1's: one block of 256 threads per
// (32, 32 x kVec) tile, a thread owning 4 rows of 16 consecutive bytes
// stored as one st.global.v4; the epilogue (g', and for rq dK/dalpha) is
// taken once per entry and reused for the B directions, whose inner
// products over the depth re-read x and y from the cache.

#include "gram_elem.cuh"

namespace {

constexpr int kJvpRows = 4;  // rows per thread

template <typename T>
__host__ __device__ constexpr int jvp_tm() {
  return kGramWarps * kJvpRows;
}
template <typename T>
__host__ __device__ constexpr int jvp_tn() {
  return 32 * kVec<T>;
}

template <int KIND, typename T>
__global__ void __launch_bounds__(kGramThreads)
gram_jvp_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ xt,
                const T* __restrict__ yt, const T* __restrict__ alpha_p,
                const T* __restrict__ at, T* __restrict__ out, int batch, int n, int m, int d,
                int vec_ok) {
  constexpr int V = kVec<T>, R = kJvpRows, TM = jvp_tm<T>(), TN = jvp_tn<T>();
  const T alpha = KIND == kRq ? __ldg(alpha_p) : T(1);  // rq's alpha, read once
  const T hia = T(0.5) / alpha;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles_n = (m + TN - 1) / TN;
  const int r0 = (blockIdx.x / tiles_n) * TM + warp * R;
  const int c0 = (blockIdx.x % tiles_n) * TN + lane * V;
  // Rows and columns past the edge read the last one: their entries are
  // not stored.
  int rows[R], cols[V];
#pragma unroll
  for (int i = 0; i < R; ++i) rows[i] = min(r0 + i, n - 1);
#pragma unroll
  for (int j = 0; j < V; ++j) cols[j] = min(c0 + j, m - 1);

  // w = 2 g'(d2), zero where the clamp makes the entry flat; h = dK/dalpha.
  T w[R][V], h[R][V];
  if (KIND != kLinear) {
    T xn[R], yn[V], acc[R][V];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      xn[i] = T(0);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[i][j] = T(0);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) yn[j] = T(0);
    for (int k = 0; k < d; ++k) {
      T xv[R], yv[V];
#pragma unroll
      for (int i = 0; i < R; ++i) xv[i] = __ldg(x + (size_t)rows[i] * d + k);
#pragma unroll
      for (int j = 0; j < V; ++j) yv[j] = __ldg(y + (size_t)cols[j] * d + k);
#pragma unroll
      for (int i = 0; i < R; ++i) xn[i] = fma(xv[i], xv[i], xn[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) yn[j] = fma(yv[j], yv[j], yn[j]);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[i][j] = fma(xv[i], yv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const T d2 = xn[i] + yn[j] - T(2) * acc[i][j];
        const bool flat = d2 < T(0);
        T kv, hv = T(0);
        const T gp = g_prime<KIND, T>(flat ? T(0) : d2, alpha, hia, &kv, &hv);
        w[i][j] = flat ? T(0) : T(2) * gp;
        h[i][j] = hv;
      }
  }

  for (int b = 0; b < batch; ++b) {
    const T* xb = xt == nullptr ? nullptr : xt + (size_t)b * n * d;
    const T* yb = yt == nullptr ? nullptr : yt + (size_t)b * m * d;
    T s[R][V];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) s[i][j] = T(0);
    for (int k = 0; k < d; ++k) {
      T xv[R], yv[V], xd[R], yd[V];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        xv[i] = __ldg(x + (size_t)rows[i] * d + k);
        xd[i] = xb == nullptr ? T(0) : __ldg(xb + (size_t)rows[i] * d + k);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        yv[j] = __ldg(y + (size_t)cols[j] * d + k);
        yd[j] = yb == nullptr ? T(0) : __ldg(yb + (size_t)cols[j] * d + k);
      }
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (KIND == kLinear)
            s[i][j] = fma(xd[i], yv[j], fma(xv[i], yd[j], s[i][j]));
          else
            s[i][j] = fma(xv[i] - yv[j], xd[i] - yd[j], s[i][j]);
        }
    }
    const T ab = KIND == kRq && at != nullptr ? __ldg(at + b) : T(0);
    T* ob = out + (size_t)b * n * m;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int r = r0 + i;
      if (r >= n) break;
      T o[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = KIND == kLinear ? s[i][j] : fma(w[i][j], s[i][j], h[i][j] * ab);
      T* dst = ob + (size_t)r * m + c0;
      if (vec_ok && c0 + V <= m) {
        store16(dst, o);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j)
          if (c0 + j < m) dst[j] = o[j];
      }
    }
  }
}

template <typename T>
cudaError_t jvp_launch(int kind, const void* xp, const void* yp, const void* xtp,
                       const void* ytp, const void* alpha, const void* atp, void* outp,
                       int batch, int n, int m, int d, int tm, int tn, cudaStream_t s) {
  const long long tiles = ((n + (long long)tm - 1) / tm) * ((m + tn - 1) / tn);
  if (tm != jvp_tm<T>() || tn != jvp_tn<T>() || tiles > 0x7fffffff ||
      (kind == kRq && alpha == nullptr))
    return cudaErrorInvalidValue;
  const T* x = static_cast<const T*>(xp);
  const T* y = static_cast<const T*>(yp);
  const T* xt = static_cast<const T*>(xtp);
  const T* yt = static_cast<const T*>(ytp);
  const T* a = static_cast<const T*>(alpha);
  const T* at = static_cast<const T*>(atp);
  T* out = static_cast<T*>(outp);
  const int vec_ok = m % kVec<T> == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int grid = (int)tiles;
#define STHENO_JVP(K) \
  gram_jvp_kernel<K, T><<<grid, kGramThreads, 0, s>>>(x, y, xt, yt, a, at, out, batch, n, m, d, vec_ok)
  switch (kind) {
    case kEq: STHENO_JVP(kEq); break;
    case kRq: STHENO_JVP(kRq); break;
    case kMatern12: STHENO_JVP(kMatern12); break;
    case kMatern32: STHENO_JVP(kMatern32); break;
    case kMatern52: STHENO_JVP(kMatern52); break;
    case kLinear: STHENO_JVP(kLinear); break;
    default: return cudaErrorInvalidValue;
  }
#undef STHENO_JVP
  return cudaGetLastError();
}

}  // namespace

// Launches the tangent kernel on `stream`: one block of 256 threads per
// (tm, tn) tile of each of the `batch` outputs' (n, m). `kind` follows the
// Kind enum of gram_kind.cuh, `dtype` the DtypeCode of gram_elem.cuh
// (float32 or float64: every pointer of it). xt (batch, n, d), yt
// (batch, m, d) and at (batch) may be null; `alpha` points to rq's alpha
// on the device (null for the other kinds). Returns cudaGetLastError()
// after the launch; the caller raises if it is not 0.
extern "C" int stheno_gram_jvp(int kind, int dtype, const void* x, const void* y, const void* xt,
                               const void* yt, const void* alpha, const void* at, void* out,
                               int batch, int n, int m, int d, int tm, int tn, void* stream) {
  if (batch <= 0 || n <= 0 || m <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32:
      return (int)jvp_launch<float>(kind, x, y, xt, yt, alpha, at, out, batch, n, m, d, tm, tn, s);
    case kF64:
      return (int)jvp_launch<double>(kind, x, y, xt, yt, alpha, at, out, batch, n, m, d, tm, tn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
