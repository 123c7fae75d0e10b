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
// read. Linear: xbar = gbar y, ybar = gbar^T x. rq: also
// d alpha = sum_ij gbar_ij K_ij (d2 / (2 alpha base) - log base).
//
// What bounds it: the read of gbar (16 MB at N = 2000 in float32, 4.8 us
// at 3.35 TB/s; 2.05 GB at 512 x 10^6, 0.61 ms); the arithmetic is about
// 15 FP32 operations and one exp per entry (float32 takes the
// special-function unit's exp and reciprocal). So gbar is copied in 16-byte
// chunks (8 for bfloat16) wherever the row stride keeps them aligned, into
// a per-warp ring of shared memory (cp.async) a step ahead of its use, and
// the two reductions stay out of device memory but for partials written
// once:
//   - the grid is spans x groups blocks (ops/gram_bwd.py:launch_shape),
//     chosen from both extents and the H100's 132 SMs. Block (a, b) sweeps
//     row group a against column span b in tiles of 128 columns, 4 a lane.
//     Square and moderate shapes (wcols = 1): a span is one tile and the
//     block's 8 warps take every 8th step of R rows. Wide ones (512 x 10^6,
//     the blocked sweep's 8192 x 262,144 tiles; wcols = 8): each warp takes
//     its own tiles of a long span and every row of the group, so its
//     columns' ybar is complete in registers;
//   - xbar: a warp's lanes share its rows, so after each step the warp
//     sums its rows' terms by recursive halving (a fixed tree) and one lane
//     writes each entry once, or adds it into the warp's rows in shared
//     memory where its rows meet several tiles (written once at the end);
//   - ybar: in registers across the warp's rows; where the block's warps
//     share a tile, summed over them in order through shared memory once
//     per tile, at the end of the block's rows;
//   - where several blocks add into an entry, each writes a slice, and a
//     second launch adds the slices in a fixed order (no atomics on values,
//     so a result is bitwise the same from run to run). It is launched as a
//     programmatic dependent of the sweep: its blocks start while the sweep
//     runs and wait for its end, which hides most of a launch's latency. The
//     partials stay a small share of gbar (1/16 at depth <= 4).
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
// (n, m); the grid of `spans` column spans of `span` (a multiple of 128
// wcols, wcols 1 or 8) by `groups` row groups of `rows`
// (ops/gram_bwd.py:launch_shape). out holds the x part (n d, when
// want_x), the y part (m d, when want_y and not fold) and rq's d alpha (one
// entry, when want_alpha); `alpha` points to rq's alpha on the device in
// the arithmetic type (null for other kinds); with fold (x is y, want_x and
// want_y) the x part is the sum of both roles. work holds the slices
// (ops/gram_bwd.py:_launch): spans x slices of n d when x is sliced,
// groups y slices of m d when y is, then groups x spans alpha partials.
// Returns cudaGetLastError() after the launches; the caller raises if it
// is not 0.
extern "C" int stheno_gram_bwd(int kind, int dtype, const void* x, const void* y,
                               const void* gbar, void* out, void* work, int n, int m, int d,
                               int groups, int rows, int spans, int span, int wcols,
                               const void* alpha, int want_x, int want_y, int want_alpha,
                               int fold, void* stream) {
  const int vv = dtype == kF64 ? 2 : 4;       // elements of a lane's load
  const int chunk = dtype == kBf16 ? 8 : 16;  // its bytes
  want_alpha = want_alpha && kind == kRq;
  if (n <= 0 || m <= 0 || d <= 0 || dtype < kF32 || dtype > kBf16 || groups <= 0 ||
      groups > 65535 || spans <= 0 || rows <= 0 || (wcols != 1 && wcols != 8) ||
      span <= 0 || span % (kBwdTile * wcols) != 0 || (long long)rows * groups < n ||
      (long long)rows * (groups - 1) >= n || (long long)span * spans < m ||
      (long long)span * (spans - 1) >= m || (fold && (n != m || !want_x || !want_y)) ||
      (kind == kRq && alpha == nullptr))
    return (int)cudaErrorInvalidValue;
  const int x_sliced = want_x && (fold || spans > 1), y_sliced = want_y && (fold || groups > 1);
  const size_t nx = want_x ? (size_t)n * d : 0, ny = want_y && !fold ? (size_t)m * d : 0;
  const size_t y_work = x_sliced ? (size_t)spans * n * d : 0;
  const size_t a_work = y_work + (y_sliced ? (size_t)groups * m * d : 0);
  if ((x_sliced || y_sliced || want_alpha) && work == nullptr) return (int)cudaErrorInvalidValue;
  const stheno::BwdArgs g{n, m, d, groups, rows, spans, span, wcols, want_x, want_y, want_alpha,
                          fold, m % vv == 0 && reinterpret_cast<uintptr_t>(gbar) % chunk == 0,
                          x_sliced, y_sliced, nx, ny, y_work, a_work};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kF32: return (int)bwd_launch<float>(kind, x, y, gbar, out, work, g, alpha, s);
    case kBf16: return (int)bwd_launch<__nv_bfloat16>(kind, x, y, gbar, out, work, g, alpha, s);
    default: return (int)stheno::gram_bwd_f64(kind, x, y, gbar, out, work, g, alpha, s);
  }
}
