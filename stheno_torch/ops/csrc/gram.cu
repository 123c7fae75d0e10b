// Fused pairwise-distance + Gram kernel (K1) for Hopper, sm_90a.
//
// Replaces the Pallas kernel stheno_tpu/ops/gram.py:_gram_kernel. It
// computes out[i, j] = g(||x_i - y_j||^2) with d2 = |x_i|^2 + |y_j|^2 -
// 2 x_i.y_j clamped at 0 (or the plain x_i.y_j for the linear kind), for
// row-major x (n, d), y (m, d) and out (n, m), in float32, float64 or
// bfloat16 storage (bfloat16 computed in float32 and rounded once, as the
// TPU kernel does), or float32 inputs with a bfloat16 output: the float32
// tile rounded once to nearest, the tile-dtype option of the matrix-free
// matvec (stheno_tpu/iterative/matvec.py: K_b.astype(tile_dtype)).
//
// What bounds it: the (n, m) output write. The contraction has depth d (2
// on the headline path, 1 on entry()'s), so the work per output element
// is a few FMAs and one transcendental: at N = 2000 in float32 the 16 MB
// store is the whole cost (about 4.8 us at 3.35 TB/s). So:
//   - the depth is a template parameter D in {1, 2, 4, 8} (gram_elem.cuh),
//     read straight into registers: no shared-memory stage, no barrier, no
//     FMA on padding beyond the next template; above 8 the same code runs
//     over passes of 8;
//   - a thread owns R rows of 16 consecutive bytes each (4 float, 2 double,
//     8 bfloat16) and stores each as one st.global.v4: a warp writes 512
//     contiguous bytes of a row. Where the row stride breaks 16-byte
//     alignment (m not a multiple of the vector) or at the ragged right
//     edge, the stores are scalar;
//   - one block per (TM, TN) tile, four resident on each SM. A persistent
//     grid (SMs x 4 blocks, each walking several tiles so that one tile's
//     stores drain while the next one's arithmetic runs) measured slower
//     on the H100: 7.63 against 7.57 us at 2000^2 and 92.6 against 85.4
//     us at 8192^2 in float32 (PERF.md).
// The exp unit is not the limit (4 M exps are about 1 us at 16 per clock
// per SM), so the epilogue keeps libdevice's expf / exp (gram_kind.cuh).
//
// The inner product and the norms use the same FMA chain, so for x is y
// the diagonal d2 is exactly 0 (and an exp kind's entry exactly 1) in all
// three dtypes.

#include "gram_elem.cuh"

namespace {

// Rows per thread: a thread builds R x kVec entries of a tile.
template <typename S>
constexpr int kFwdRows = sizeof(S) == 2 ? 2 : 4;

template <typename S>
__host__ __device__ constexpr int fwd_tm() {
  return kGramWarps * kFwdRows<S>;
}
template <typename S>
__host__ __device__ constexpr int fwd_tn() {
  return 32 * kVec<S>;
}

// SI: the inputs' storage type; S: the output's, which sets the tile.
template <int KIND, typename SI, typename S, int D>
__global__ void __launch_bounds__(kGramThreads, 4)
gram_kernel(const SI* __restrict__ x, const SI* __restrict__ y, S* __restrict__ out, int n, int m,
            int d, typename Arith<S>::T alpha, int vec_ok) {
  using T = typename Arith<S>::T;
  constexpr int V = kVec<S>, R = kFwdRows<S>, TM = fwd_tm<S>(), TN = fwd_tn<S>();
  constexpr int DC = D == 0 ? 8 : D;  // depth per pass
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int depth = D == 0 ? d : D;
  const int tiles_n = (m + TN - 1) / TN;  // tiles in row-major order
  const int t = blockIdx.x;
  const int r0 = (t / tiles_n) * TM + warp * R;
  const int c0 = (t % tiles_n) * TN + lane * V;
  T acc[R][V], xn[R], yn[V];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    xn[i] = T(0);
#pragma unroll
    for (int j = 0; j < V; ++j) acc[i][j] = T(0);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) yn[j] = T(0);

  // Rows and columns past the edge read the last one: their entries
  // are not stored. One depth at a time, so that only R + V inputs are
  // live beside the R x V sums.
  const SI* xr[R];
  const SI* yr[V];
#pragma unroll
  for (int i = 0; i < R; ++i) xr[i] = x + (size_t)min(r0 + i, n - 1) * d;
#pragma unroll
  for (int j = 0; j < V; ++j) yr[j] = y + (size_t)min(c0 + j, m - 1) * d;
  for (int k0 = 0; k0 < depth; k0 += DC) {
#pragma unroll
    for (int k = 0; k < DC; ++k) {
      const bool in = k < d - k0;  // zeros past d change no sum
      T xv[R], yv[V];
#pragma unroll
      for (int i = 0; i < R; ++i) xv[i] = in ? to_arith(__ldg(xr[i] + k0 + k)) : T(0);
#pragma unroll
      for (int j = 0; j < V; ++j) yv[j] = in ? to_arith(__ldg(yr[j] + k0 + k)) : T(0);
#pragma unroll
      for (int i = 0; i < R; ++i) xn[i] = fma(xv[i], xv[i], xn[i]);
#pragma unroll
      for (int j = 0; j < V; ++j) yn[j] = fma(yv[j], yv[j], yn[j]);
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int j = 0; j < V; ++j) acc[i][j] = fma(xv[i], yv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = r0 + i;
    if (r >= n) break;
    S o[V];
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = to_storage<S>(epilogue<KIND, T>(xn[i] + yn[j] - T(2) * acc[i][j], acc[i][j], alpha));
    S* dst = out + (size_t)r * m + c0;
    if (vec_ok && c0 + V <= m) {
      store16(dst, o);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (c0 + j < m) dst[j] = o[j];
    }
  }
}

template <int KIND, typename SI, typename S>
void launch_depth(int dt, const SI* x, const SI* y, S* out, int n, int m, int d,
                  typename Arith<S>::T alpha, int vec_ok, int tiles, cudaStream_t s) {
  switch (dt) {
    case 1: gram_kernel<KIND, SI, S, 1><<<tiles, kGramThreads, 0, s>>>(x, y, out, n, m, d, alpha, vec_ok); break;
    case 2: gram_kernel<KIND, SI, S, 2><<<tiles, kGramThreads, 0, s>>>(x, y, out, n, m, d, alpha, vec_ok); break;
    case 4: gram_kernel<KIND, SI, S, 4><<<tiles, kGramThreads, 0, s>>>(x, y, out, n, m, d, alpha, vec_ok); break;
    case 8: gram_kernel<KIND, SI, S, 8><<<tiles, kGramThreads, 0, s>>>(x, y, out, n, m, d, alpha, vec_ok); break;
    default: gram_kernel<KIND, SI, S, 0><<<tiles, kGramThreads, 0, s>>>(x, y, out, n, m, d, alpha, vec_ok); break;
  }
}

// A launch whose tile shape (tm, tn) is not the kernel's is refused: the
// wrapper's tiling (ops/gram.py:tile_shape) is then not the kernel's.
template <typename SI, typename S>
cudaError_t launch(int kind, const void* xp, const void* yp, void* outp, int n, int m, int d,
                   double alpha, int tm, int tn, cudaStream_t s) {
  const long long tiles = ((n + (long long)tm - 1) / tm) * ((m + tn - 1) / tn);
  if (tm != fwd_tm<S>() || tn != fwd_tn<S>() || tiles > 0x7fffffff) return cudaErrorInvalidValue;
  const SI* x = static_cast<const SI*>(xp);
  const SI* y = static_cast<const SI*>(yp);
  S* out = static_cast<S*>(outp);
  const int vec_ok = m % kVec<S> == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int dt = depth_template(d);
  const auto a = static_cast<typename Arith<S>::T>(alpha);
  switch (kind) {
    case kEq: launch_depth<kEq, SI, S>(dt, x, y, out, n, m, d, a, vec_ok, (int)tiles, s); break;
    case kRq: launch_depth<kRq, SI, S>(dt, x, y, out, n, m, d, a, vec_ok, (int)tiles, s); break;
    case kMatern12: launch_depth<kMatern12, SI, S>(dt, x, y, out, n, m, d, a, vec_ok, (int)tiles, s); break;
    case kMatern32: launch_depth<kMatern32, SI, S>(dt, x, y, out, n, m, d, a, vec_ok, (int)tiles, s); break;
    case kMatern52: launch_depth<kMatern52, SI, S>(dt, x, y, out, n, m, d, a, vec_ok, (int)tiles, s); break;
    case kLinear: launch_depth<kLinear, SI, S>(dt, x, y, out, n, m, d, a, vec_ok, (int)tiles, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// Launches K1 on `stream`: one block of 256 threads per (tm, tn) tile of
// out. `kind` follows the Kind enum of gram_kind.cuh, `dtype` the
// DtypeCode of gram_elem.cuh (float32, float64, bfloat16: x, y and out all
// of it; or float32 x and y with a bfloat16 out). Returns cudaGetLastError() after the launch; the caller
// raises if it is not 0.
extern "C" int stheno_gram(int kind, int dtype, const void* x, const void* y, void* out, int n,
                           int m, int d, double alpha, int tm, int tn, void* stream) {
  if (n <= 0 || m <= 0 || d < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)launch<float, float>(kind, x, y, out, n, m, d, alpha, tm, tn, s);
    case kF64: return (int)launch<double, double>(kind, x, y, out, n, m, d, alpha, tm, tn, s);
    case kBf16:
      return (int)launch<__nv_bfloat16, __nv_bfloat16>(kind, x, y, out, n, m, d, alpha, tm, tn, s);
    case kF32Bf16:
      return (int)launch<float, __nv_bfloat16>(kind, x, y, out, n, m, d, alpha, tm, tn, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
