// Forward-mode (tangent) kernel of K1's backward for Hopper, sm_90a.
//
// The forward rule of K1's backward (gram_bwd.cu), so that a second
// derivative through the fused Gram (torch.func.hessian's forward over
// reverse, and reverse over reverse through ops/gram_bwd.py:_GramBwd's
// backward) runs on the card. It replaces no Pallas kernel: on the TPU the
// JAX package's forward mode differentiates the XLA backward _gram_bwd
// (stheno_tpu/ops/gram.py:198) op by op. For x (n, d), y (m, d), the
// cotangent gbar (n, m) and B tangent directions (xt (B, n, d), yt (B, m,
// d), gt (B, n, m) and rq's at (B), each possibly null: a zero tangent) it
// computes, with W = gbar g'(d2), r_ij = x_i - y_j and rt = xt_i - yt_j,
//   xbar'_i = 2 sum_j [W'_ij r_ij + W_ij rt_ij],   ybar'_j = -2 sum_i [same],
//   W'_ij = gt_ij g' + gbar_ij g'' d2'_ij + gbar_ij (d g'/d alpha) at,
//   d2'_ij = 2 <r_ij, rt_ij>,
// and for rq the tangent of d alpha = sum_ij gbar_ij h_ij (h = dK/d alpha):
//   sum_ij [gt_ij h + gbar_ij ((d g'/d alpha) d2' + (d h / d alpha) at)].
// Linear: xbar' = gt y + gbar yt, ybar' = gt^T x + gbar^T xt. With fold (x
// is y, and yt is xt) the x part is the sum of both roles, as gram_bwd.cu
// folds them. d2 is K1's FMA chain clamped at 0; where the clamp bites
// (d2 < 0, rounding) the entry is flat in d2 and its d2' terms are 0.
//
// Coincident points: where r_ij = 0 exactly (the diagonal when x is y:
// x_i - x_i) d2' is 0, and a d2' of 0 drops its terms outright instead of
// multiplying g'' by it, since Matérn-1/2's g'' overflows float32 there
// (gram_kind.cuh:g_second). When x is y the diagonal's rt is 0 too, so its
// terms W' r + W rt are exactly 0 whatever gbar and gt hold there: the
// diagonal adds nothing to the sums, as in gram_bwd.cu's direct form.
//
// What bounds it: reading gbar and the B tangent tiles gt, (1 + B) n m
// entries: 64.1 MB at the flagship's 2000 x 2000, B = 3, float32, 19.1 us
// at 3.35 TB/s; the arithmetic, some 20 + 13 B operations an entry, binds
// far less. So the design keeps every other byte and every barrier out of
// the sweep (gram_bwd_jvp.cuh):
//   - one block per (row group, column span of 128): a lane's 4 columns are
//     one 16-byte vector of float32 or two of float64, each load of a warp
//     512 consecutive bytes of a row, wherever the row stride keeps them
//     aligned (scalar loads otherwise); row groups sized by
//     ops/gram_bwd_jvp.py:bwd_jvp_shape, swept in steps of 8 warps x R rows;
//   - the next step's loads in flight during a step's arithmetic: float32
//     tiles into registers a step ahead; float64 tiles, twice the bytes an
//     entry, copied by cp.async into a ring of shared memory, 2 to 4 steps
//     in flight, each lane reading back only what it copied (no barrier);
//     what does not change from step to step (tile pointers, the lane's
//     columns and their tests, where its x sum goes) is worked out once;
//   - every direction of a call in one sweep at depth 1, up to 8 (the
//     instance sized to the batch: 1, 2, 3, 4 or 8), so gbar is read once;
//     more directions take further sweeps of 8. Deeper, one sweep per
//     direction and depth slice of 8 (the partials' registers grow as
//     directions x depth);
//   - d2, g', g'' (and rq's terms) once per entry, from the row's and the
//     column's data in registers; the columns' tangents staged once in
//     shared memory;
//   - the y partials in registers per lane column across the whole row
//     sweep, summed over the warps through shared memory once per block and
//     (direction, depth); the x partials of a row are complete after its
//     step (one column span a block): summed over the lanes by recursive
//     halving (a fixed tree), then written once. Each block writes each
//     entry of its slices once, with no read-modify-write and no barrier
//     inside the sweep;
//   - the slices added in a fixed order by gram_matvec.cuh's reduce_splits
//     (x's, then with fold the y role's into the same sum), so a result is
//     bitwise the same from run to run; no atomics.
// On an H100 (80 GB HBM3, 700 W) a call at 2000 x 2000, eq, x is y, takes
// about 0.035 ms of device time at B = 3 in float32 (bound 0.019), 0.019 ms
// at B = 1 (bound 0.0096) and 0.058 ms at B = 3 in float64 (bound 0.038),
// the sweep and the sum; the design before this one took 0.177 at B = 3
// (PERF.md, scripts/torch_k1.py jvb). The sweep issues about 120
// instructions an entry at B = 3 in float32, most of them for its loads'
// addresses and the sums' bookkeeping: it is bound by issue more than by
// the bytes. float32 and float64 (gram_bwd_jvp_f64.cu).

#include "gram_bwd_jvp.cuh"

// Launches the forward rule of K1's backward on `stream`. `kind` follows
// the Kind enum of gram_kind.cuh, `dtype` the DtypeCode of gram_elem.cuh
// (float32 or float64: every pointer of it). x (n, d), y (m, d), gbar (n,
// m); gt (batch, n, m), xt (batch, n, d), yt (batch, m, d) and at (batch)
// may be null (no tangent); `alpha` points to rq's alpha on the device
// (null for the other kinds). The grid: `splits` row groups of `rows`
// against ceil(m / span) column spans of `span`, which must be 128, 4
// columns a lane (ops/gram_bwd_jvp.py:bwd_jvp_shape). out holds the x
// part (batch n d, when want_x), the y part (batch m d, when want_y and
// not fold) and the alpha partials (batch x splits x spans, rq with
// want_alpha); with fold (x is y and xt is yt, want_x) the x part is the
// sum of both roles.
// work holds the slices (gram_bwd_jvp.cuh:JvbArgs). Returns
// cudaGetLastError() after the launches; the caller raises if it is not 0.
extern "C" int stheno_gram_bwd_jvp(int kind, int dtype, const void* x, const void* y,
                                   const void* gbar, const void* gt, const void* xt,
                                   const void* yt, const void* alpha, const void* at, void* out,
                                   void* work, int batch, int n, int m, int d, int rows,
                                   int span, int splits, int want_x, int want_y, int want_alpha,
                                   int fold, void* stream) {
  want_alpha = want_alpha && kind == kRq;
  if (fold) want_y = 1;
  if (batch <= 0 || n <= 0 || m <= 0 || d <= 0 || (dtype != kF32 && dtype != kF64) ||
      splits <= 0 || splits > 65535 || rows <= 0 || span != kJvbSpan ||
      (long long)rows * splits < n || (long long)rows * (splits - 1) >= n ||
      (fold && (n != m || !want_x)) || (kind == kRq && alpha == nullptr))
    return (int)cudaErrorInvalidValue;
  const int spans = (m + span - 1) / span;
  const size_t nx = (size_t)batch * n * d, ny = (size_t)batch * m * d;
  if ((want_x || want_y) && work == nullptr) return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  const int vec = dtype == kF64 ? 2 : 4;
  const stheno::JvbArgs g{n, m, d, rows, splits, spans, batch, want_x, want_y, want_alpha, fold,
                          m % vec == 0 && aligned(gbar) && (gt == nullptr || aligned(gt)), nx,
                          ny};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)jvb_launch<float>(kind, x, y, gbar, gt, xt, yt, alpha, at, out, work, g, s);
  return (int)stheno::gram_bwd_jvp_f64(kind, x, y, gbar, gt, xt, yt, alpha, at, out, work, g, s);
}
