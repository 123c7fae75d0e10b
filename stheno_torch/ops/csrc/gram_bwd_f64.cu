// The float64 instantiation of K1's backward kernel (gram_bwd.cuh), built
// by its own nvcc process beside gram_bwd.cu, whose C entry point calls it.

#include "gram_bwd.cuh"

namespace stheno {

cudaError_t gram_bwd_f64(int kind, const void* x, const void* y, const void* gbar, void* out,
                         void* work, const BwdArgs& g, const void* alpha, cudaStream_t s) {
  return bwd_launch<double>(kind, x, y, gbar, out, work, g, alpha, s);
}

}  // namespace stheno
