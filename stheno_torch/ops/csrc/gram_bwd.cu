// K1's backward (the gradient of the fused Gram) for Hopper, sm_90a.
//
// Replaces the JAX package's _gram_bwd (stheno_tpu/ops/gram.py:198), the
// XLA backward of the Pallas kernel _gram_kernel: there the W-trick
// xbar = 2 (rowsum(W) x - W y), W = gbar * g'(d2), is about 12 launches
// and forms W in device memory (written once, read four times). Here one
// kernel reads the cotangent gbar (n, m) once and computes, for x (n, d)
// and y (m, d) in float32, float64 or bfloat16 storage (bfloat16 in
// float32 arithmetic, rounded once by the wrapper):
//   xbar_i = 2 sum_j W_ij (x_i - y_j),   ybar_j = 2 sum_i W_ij (y_j - x_i),
// with W = gbar * g'(d2) and d2 and g' recomputed in registers by the
// forward's FMA chain (gram.cu) and gram_kind.cuh's g_prime: K is not
// read. Linear: xbar = gbar y, ybar = gbar^T x. rq: also the partials of
// d alpha = sum_ij gbar_ij K_ij (d2 / (2 alpha base) - log base).
//
// What bounds it: the read of gbar (16 MB at N = 2000 in float32, 4.8 us
// at 3.35 TB/s); the arithmetic is about 15 FP32 operations and one exp
// per entry. So gbar is read as 16-byte vectors (4 float, 2 double, 8
// bfloat16 a thread) wherever the row stride keeps them aligned, and the
// two reductions stay out of device memory but for partials:
//   - the grid is S x S blocks (ops/gram_bwd.py:launch_shape): block (a,
//     b) sweeps row group a against column span b, column sub-tiles of 32
//     vectors outer, row sub-tiles inner;
//   - xbar: a warp's lanes share its rows, so after each sub-tile the warp
//     sums its rows' terms with a fixed xor butterfly and adds them into
//     its block's slice b (no other block writes those entries);
//   - ybar: the block's warps share its columns, so after its rows each
//     column's terms are summed over the warps in order through shared
//     memory and written into slice a;
//   - the S slices (2 S when x is y: both roles into one sum) are added
//     in a fixed order by gram_matvec.cuh's reduce_splits, a second
//     launch where S > 1. No atomics: a result is bitwise the same from
//     run to run. The partials are S (n + m) d, a small fraction of gbar.
// The direct form sum_j W_ij (x_i - y_j) gives Matern-1/2's diagonal at
// x is y (g' = -0.5 / 1e-18 there) exactly 0, where the W-trick cancels
// two large sums.

#include "gram_bwd.cuh"

namespace stheno {
cudaError_t gram_bwd_f64(int kind, const void* x, const void* y, const void* gbar, void* out,
                         void* work, const BwdArgs& g, const void* alpha, cudaStream_t s);
}  // namespace stheno

// Launches K1's backward on `stream`. `kind` follows the Kind enum of
// gram_kind.cuh, `dtype` the DtypeCode of gram_elem.cuh (x, y and gbar all
// of it; out and work are float32 for bfloat16). x (n, d), y (m, d), gbar
// (n, m); the S x S grid (S = splits) of row groups of `rows` and column
// spans of `span`, whole 16-byte vectors (ops/gram_bwd.py:launch_shape).
// out holds the x part (n d, when want_x), the y part (m d, when want_y
// and not fold) and S alpha partials (rq with want_alpha); `alpha` points to
// rq's alpha on the device in the arithmetic type (null for other kinds); with fold (x is
// y, want_x and want_y) the x part is the sum of both roles. work holds S such slices (2 S with fold) when
// there are several. Returns cudaGetLastError() after the launches; the
// caller raises if it is not 0.
extern "C" int stheno_gram_bwd(int kind, int dtype, const void* x, const void* y,
                               const void* gbar, void* out, void* work, int n, int m, int d,
                               int rows, int span, int splits, const void* alpha, int want_x,
                               int want_y, int want_alpha, int fold, void* stream) {
  const int vec = dtype == kF64 ? 2 : dtype == kBf16 ? 8 : 4;
  want_alpha = want_alpha && kind == kRq;
  if (n <= 0 || m <= 0 || d <= 0 || dtype < kF32 || dtype > kBf16 ||
      splits <= 0 || splits > 65535 || rows <= 0 || span <= 0 || span % vec != 0 ||
      (long long)rows * splits < n || (long long)span * splits < m ||
      (long long)span * (splits - 1) >= m || (fold && (n != m || !want_x || !want_y)) ||
      (kind == kRq && alpha == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t nx = want_x ? (size_t)n * d : 0;
  const size_t ny = want_y && !fold ? (size_t)m * d : 0;
  const size_t na = want_alpha ? (size_t)splits : 0;
  const int slices = fold ? 2 * splits : splits;
  if (slices > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  const stheno::BwdArgs g{n, m, d, rows, span, splits, want_x, want_y, want_alpha, fold,
                          m % vec == 0 && reinterpret_cast<uintptr_t>(gbar) % 16 == 0,
                          nx + ny + na, fold ? 0 : nx, nx + ny};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)bwd_launch<float>(kind, x, y, gbar, out, work, g, alpha, s);
    case kBf16: return (int)bwd_launch<__nv_bfloat16>(kind, x, y, gbar, out, work, g, alpha, s);
    default: return (int)stheno::gram_bwd_f64(kind, x, y, gbar, out, work, g, alpha, s);
  }
}
