// Fused Gram x V kernel (K3) for Hopper, sm_90a.
//
// Replaces the Pallas kernel stheno_tpu/ops/gram_matvec.py:_gmv_kernel. It
// computes out = G @ v with G[i, j] = g(||x_i - y_j||^2) (or x_i.y_j for
// the linear kind), for row-major x (n, d), y (m, d), v (m, p) and out
// (n, p), without ever storing G: each entry is built in registers, used
// for its p products and dropped.
//
// What bounds it: operations, not bytes. The sweep does 2 n m p FMA flops
// (plus the distance and the epilogue per entry) against O((n + m)(d + p))
// bytes, so at the iterative path's shapes (n = m = 262,144, p = 1..256)
// every byte is reused thousands of times. For p = 1 the one exp per
// entry sets the floor: the special-function unit does 16 per clock per
// SM, an eighth of the FP32 FMA rate.
//
// Design. The TPU kernel keeps a (512, P) output block resident in VMEM
// over an in-order sweep of the column blocks; on Hopper, blocks run in
// parallel and in no order, so each block owns a strip of rows and sweeps
// the columns itself:
//   - a thread owns R rows (x and |x|^2 in registers) and PC output
//     columns (FP32/FP64 accumulators in registers); a block of 128
//     threads owns TM = 128 R rows;
//   - per pass, a chunk of kTN columns of y (with |y|^2) and the kTN x PC
//     block of v are staged in shared memory; every thread reads the same
//     entry at the same time, so these reads are broadcasts;
//   - each entry g is computed once per thread and row and multiplied
//     into the PC accumulators, so one v load feeds R FMAs; each pass's
//     products are summed apart and then added to the running total, so
//     no accumulator runs a float32 sum over more than about
//     kTN + span / kTN terms;
//   - p wider than PC is split across blockIdx.y (each split recomputes
//     its entries); where rows x p-splits leave the card short of blocks,
//     the column sweep is split across blockIdx.z into `span`-wide ranges
//     whose partial sums a second kernel adds in a fixed order: no
//     atomics, so the operator is the same on every call, as CG wants.
// Ragged edges are masked: rows beyond n are not written, and columns
// beyond m stage y = 0 and v = 0, so they add exactly nothing. Every
// product is an FP32 (or FP64) FMA: no TF32, no tensor cores. The norms
// and the inner product share K1's FMA chain (gram_kind.cuh), so d2 is
// exactly 0 where x is y.

#include "gram_matvec.cuh"

namespace stheno {
// Defined in gram_matvec_f64.cu, which nvcc builds beside this file.
cudaError_t gram_matvec_f64(int kind, int pc, const double* x, const double* y, const double* v,
                            double* out, double* work, int n, int m, int d, int p, int span,
                            int splits, double alpha, cudaStream_t s);
}  // namespace stheno

// Launches K3 on `stream`: out (n, p) = G(x, y) @ v. `kind` follows the
// Kind enum of gram_kind.cuh; `is_double` selects float64 (else float32);
// `pc` (1, 4, 8, 16 or 32) is the output columns a thread accumulates;
// the column sweep is split into `splits` ranges of `span` columns. With
// splits > 1, `work` holds splits * n * p partial sums (else it is not
// read). Returns cudaGetLastError() after the launches; the caller raises
// if it is not 0.
extern "C" int stheno_gram_matvec(int kind, int is_double, const void* x, const void* y,
                                  const void* v, void* out, void* work, int n, int m, int d,
                                  int p, int pc, int span, int splits, double alpha,
                                  void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || p <= 0 || span <= 0 || splits <= 0 || splits > 65535 ||
      (long long)span * splits < m || (splits > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double)
    return (int)stheno::gram_matvec_f64(kind, pc, static_cast<const double*>(x),
                                        static_cast<const double*>(y),
                                        static_cast<const double*>(v), static_cast<double*>(out),
                                        static_cast<double*>(work), n, m, d, p, span, splits,
                                        alpha, s);
  return (int)launch<float>(kind, pc, static_cast<const float*>(x), static_cast<const float*>(y),
                            static_cast<const float*>(v), static_cast<float*>(out),
                            static_cast<float*>(work), n, m, d, p, span, splits, (float)alpha, s);
}
