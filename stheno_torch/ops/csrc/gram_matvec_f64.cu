// The float64 instantiation of K3 (gram_matvec.cuh), built by its own nvcc
// process beside gram_matvec.cu, whose C entry point calls it.

#include "gram_matvec.cuh"

namespace stheno {

cudaError_t gram_matvec_f64(int kind, int pc, const double* x, const double* y, const double* v,
                            double* out, double* work, int n, int m, int d, int p, int span,
                            int splits, double alpha, cudaStream_t s) {
  return launch<double>(kind, pc, x, y, v, out, work, n, m, d, p, span, splits, alpha, s);
}

}  // namespace stheno
