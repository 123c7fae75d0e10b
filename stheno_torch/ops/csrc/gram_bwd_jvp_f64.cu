// The float64 instantiation of the forward rule of K1's backward
// (gram_bwd_jvp.cuh), built by its own nvcc process beside gram_bwd_jvp.cu,
// whose C entry point calls it.

#include "gram_bwd_jvp.cuh"

namespace stheno {

cudaError_t gram_bwd_jvp_f64(int kind, const void* x, const void* y, const void* gbar,
                             const void* gt, const void* xt, const void* yt, const void* alpha,
                             const void* at, void* out, void* work, const JvbArgs& g,
                             cudaStream_t s) {
  return jvb_launch<double>(kind, x, y, gbar, gt, xt, yt, alpha, at, out, work, g, s);
}

}  // namespace stheno
