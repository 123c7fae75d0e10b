// The float64 instantiation of the fused Gram-gradient x V kernel
// (gram_matvec_vjp.cuh), built by its own nvcc process beside
// gram_matvec_vjp.cu, whose C entry point calls it.

#include "gram_matvec_vjp.cuh"

namespace stheno {

cudaError_t gram_matvec_vjp_f64(int kind, int d, int qc, const double* x, const double* y,
                                const double* a, const double* v, double* out, double* work,
                                int n, int m_pad, int q, int span, int splits, int qsplits,
                                double alpha, int want_alpha, int want_value, int tm,
                                cudaStream_t s) {
  const VjpArgs g{n, m_pad, q, span, splits, qsplits, want_alpha, want_value, tm};
  return vjp_launch<double>(kind, d, qc, x, y, a, v, out, work, g, alpha, s);
}

}  // namespace stheno
