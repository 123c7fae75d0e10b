// Fused Gram-gradient x V kernel for Hopper, sm_90a: the backward of the
// fused Gram x V product (K3) with respect to its inputs, and the value
// of the bilinear form that product defines.
//
// Replaces, on the matrix-free path's surrogate gradient, what the JAX
// package differentiates there: jax.grad through kernel_matvec's K1 tiles
// (the Pallas kernel stheno_tpu/ops/gram.py:_gram_kernel) and their
// custom VJP _gram_bwd (the W-trick in jnp, stheno_tpu/ops/gram.py:
// 197-223), times V. On the same path it also replaces the surrogate's
// forward sweep: on the card that was K3's float64 route
// (stheno_tpu/ops/gram_matvec.py:53, _gmv_kernel; on the TPU, the K1
// tiles that jax.grad saves as residuals). For x (n, d), y (m, d), A
// (n, q) and V (m, q) it computes, for the five distance kinds of
// gram_kind.cuh,
//   xbar_i = 2 sum_j W_ij (x_i - y_j),  W_ij = (A V^T)_ij g'(d2_ij),
// with want_value the rows' partials of
//   value = sum_ij (A V^T)_ij K_ij  (= sum(A * (G(x, y) V))),
// and for rq the rows' partials of
//   dalpha = sum_ij (A V^T)_ij K_ij (d2_ij / (2 alpha base_ij) - log base_ij),
// without forming any (n, m) array: no Gram tile, no W, no A V^T. The
// column role ybar is the same kernel called with (y, x, V, A). Where x
// is y (the square Gram), the wrapper fuses both roles into one launch:
// with A' = [A, V] and V' = [V, A], A'_i . V'_j = (A V^T)_ij + (A V^T)_ji,
// so one sweep gives xbar + ybar, twice the value and twice dalpha, and
// one exp per entry serves both roles. The linear kind needs no sweep
// (xbar = A (V^T y), a small product in torch).
//
// Why one sweep replaces two: the surrogate's gradient needs, of its
// forward product K [w, alpha], only the scalar that the scales' gradient
// reads, sum(A * (K V)); everything else the backward rebuilds in
// registers. The entry K_ij and the dot (A V^T)_ij are already in hand
// when the gradient term is formed (for eq K = -2 g'; the Matérn kinds and
// rq add their polynomial factor to the exp they take anyway), so the
// value costs one FMA per entry and a fourth running sum per row, where
// the separate forward took a whole float64 sweep: N^2 entries, a
// float64 exp for each, and 17 columns padded to 32 on DFMA.
//
// Each difference x_i - y_j is formed once and serves both d2 and the
// gradient: sum_j W_ij (x_i - y_j) directly, not the W-trick's
// rowsum(W) x_i - (W y)_i, whose two sums cancel. That keeps Matérn-1/2
// finite where x_i = y_j (its g' is -0.5 / 1e-18 there, times a zero
// difference) and costs no more: one subtraction instead of one addition
// per entry and dimension.
//
// What bounds it: operations. Per entry and launch it does the q-wide dot
// A_i . V_j (q FMAs), the distance (2 d), one exp, d + 1 FMAs for the
// gradient and one for the value; the bytes are O((n + m)(d + q)), each
// reused about ten thousand times at the path's shape (n = m = 262,144,
// d = 1, q = 2 x 17 with both roles, float64). In float64 there is no
// special-function unit: the exp is a polynomial of about fifteen FP64
// operations. With the dot on DFMA too
// (a first version of this kernel), the FP64 units did some 60 operations
// per entry; the dot on the FP64 tensor cores leaves them about 20.
//
// Design, for Hopper rather than block by block from Pallas (which built
// and stored each (TM, TN) tile and left the backward to XLA):
//   - a block owns a strip of rows and sweeps all columns (no in-order grid
//     on Hopper); Gram and g' entries are built in registers;
//   - per pass of 64 columns, the rows of y and of the panel V (padded by
//     the wrapper to QC = 4, 8, 20 or 36 columns, zero-filled) are copied
//     into shared memory by 16-byte cp.async, double-buffered one pass
//     ahead;
//   - float64 (gmv_vjp_dmma_kernel): a warp holds 8-row groups of A as
//     mma.m8n8k4.f64 A fragments; per 8-column tile of the panel, one B
//     fragment per k-step serves all of the warp's groups, and each lane
//     gets two dots of each group's 8x8 tile, for which it builds the
//     distance, K, g' and the gradient and value terms; each pass's value
//     terms are summed from zero and the pass totals added into a
//     compensated (Kahan) sum in shared memory; the four lanes of a row
//     add their sums by shuffles at the end, in a fixed order;
//   - float32 (gmv_vjp_kernel, FFMA, as the K1-tile route accumulated): a
//     thread holds up to 4 rows of x and A in registers, reads each panel
//     row as 16-byte broadcasts (each load feeds the thread's rows), and
//     runs the dot in 4 interleaved partial sums; each pass's terms are
//     summed from zero and then added to the running total (the two-level
//     sum of gram_matvec.cu);
//   - q wider than QC splits over blockIdx.y (the sum is linear in the
//     columns of A and V, so the splits add); where the row blocks are few
//     the column sweep splits over blockIdx.z. The partial gradients and
//     the rows' alpha and value partials are added by gmv_vjp_reduce in a
//     fixed order: no atomics, so one shape always sums in one order;
//   - depth is a template (d = 1, 2, 4 or 8; the wrapper pads x and y with
//     zero columns, which add nothing to d2 or to the gradient).
// Every product is an FP32 (float32) or FP64 (float64) product: no TF32.
// Columns beyond m are zero rows of y and V, which add exactly nothing
// (their dot is 0); rows beyond n are not written.

#include "gram_matvec_vjp.cuh"

namespace stheno {
// Defined in gram_matvec_vjp_f64.cu, which nvcc builds beside this file.
cudaError_t gram_matvec_vjp_f64(int kind, int d, int qc, const double* x, const double* y,
                                const double* a, const double* v, double* out, double* work,
                                int n, int m_pad, int q, int span, int splits, int qsplits,
                                double alpha, int want_alpha, int want_value, int tm,
                                cudaStream_t s);
}  // namespace stheno

// Launches the kernel on `stream`. `kind` follows the Kind enum of
// gram_kind.cuh (not linear); `is_double` selects float64 (else float32).
// x is (n, d) and y (m_pad, d) with d in {1, 2, 4, 8}, a (n, q), v
// (qsplits, m_pad, qc) with qc in {4, 8, 20, 36}; m_pad and span are
// multiples of 64. out holds n * d gradient entries, then n alpha
// partials when want_alpha, then n value partials when want_value; with
// splits * qsplits > 1, work holds that many such slices. tm is the rows
// per block the caller sized the split for; a launch refuses a tm that is
// not its kernel's. Returns cudaGetLastError() after the launches; the
// caller raises if it is not 0.
extern "C" int stheno_gram_matvec_vjp(int kind, int is_double, const void* x, const void* y,
                                      const void* a, const void* v, void* out, void* work, int n,
                                      int m_pad, int d, int q, int qc, int span, int splits,
                                      int qsplits, double alpha, int want_alpha,
                                      int want_value, int tm, void* stream) {
  if (n <= 0 || m_pad <= 0 || m_pad % kVjpTN != 0 || q <= 0 || span <= 0 ||
      span % kVjpTN != 0 || splits <= 0 || splits > 65535 || qsplits <= 0 || qsplits > 65535 ||
      (long long)span * splits < m_pad || (long long)qsplits * qc < q ||
      (splits * qsplits > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return (int)stheno::gram_matvec_vjp_f64(
        kind, d, qc, static_cast<const double*>(x), static_cast<const double*>(y),
        static_cast<const double*>(a), static_cast<const double*>(v), static_cast<double*>(out),
        static_cast<double*>(work), n, m_pad, q, span, splits, qsplits, alpha, want_alpha,
        want_value, tm, s);
  const VjpArgs g{n, m_pad, q, span, splits, qsplits, want_alpha, want_value, tm};
  return (int)vjp_launch<float>(kind, d, qc, static_cast<const float*>(x),
                                static_cast<const float*>(y), static_cast<const float*>(a),
                                static_cast<const float*>(v), static_cast<float*>(out),
                                static_cast<float*>(work), g, (float)alpha, s);
}
