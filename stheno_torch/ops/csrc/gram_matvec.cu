// Fused Gram x V kernel (K3) for Hopper, sm_90a: float32 with p <= 16.
//
// Replaces, with gram_matvec_mma.cu (float32, p >= 17) and
// gram_matvec_f64.cu (float64), the Pallas kernel
// stheno_tpu/ops/gram_matvec.py:_gmv_kernel. It computes out = G @ v with
// G[i, j] = g(||x_i - y_j||^2) (or x_i.y_j for the linear kind), for
// row-major x (n, d), y (m, d), v (m, p) and out (n, p), without ever
// storing G: each entry is built in registers, used for its p products
// and dropped.
//
// What bounds it: operations, not bytes. The sweep does 2 n m p FMA flops
// plus the distance and the epilogue per entry against O((n + m)(d + p))
// bytes. At p = 1 (the serving weights and mean) the one exp per entry
// sets the floor: the special-function unit (MUFU) does 16 per clock per
// SM, an eighth of the FP32 rate, so a warp's exp takes 8 of its
// scheduler's issue slots.
//
// Design. The TPU kernel keeps a (512, P) output block resident in VMEM
// over an in-order sweep of the column blocks; on Hopper, blocks run in
// parallel and in no order, so each block owns a strip of rows and sweeps
// the columns itself:
//   - a thread owns R rows (x and |x|^2 in registers) and PC output
//     columns (FP32 accumulators); a block of 128 threads owns 128 R rows;
//   - per pass, kTN columns of y (with |y|^2) and the kTN x PC block of v
//     are staged in shared memory; every thread reads the same entry at
//     the same time, so these reads are broadcasts, and one read feeds R
//     rows;
//   - the exp kinds run in base 2 on MUFU.EX2 (ex2.approx.ftz.f32), with
//     their constant folded into x and y when they are loaded (prescale):
//     eq scales by sqrt(log2(e) / 2), so that the scaled d2 is the
//     exponent; the Matérns by sqrt(2 nu) log2(e), so that the scaled
//     distance is. An entry then costs the inner product's FMA, the
//     norms' add, the distance FMA (-2 inner + the norms), the clamp, one
//     MUFU.EX2 (with the negation folded into its operand) and the
//     product's FMA: five FP32 issue slots against the exp's eight, so the exp unit, not the FP32
//     issue rate, sets the pace (libdevice's expf, without fast math,
//     wraps MUFU.EX2 in a range reduction of four to six more FP32
//     instructions). ex2.approx is within 2 ulp of 2^x; rq and linear
//     keep their arithmetic;
//   - each pass's products are summed apart and then added to the
//     running total, so no accumulator runs a float32 sum over more than
//     about kTN + span / kTN terms;
//   - p wider than PC is split across blockIdx.y (each split recomputes
//     its entries); where rows x p-splits leave the card short of blocks,
//     the column sweep is split across blockIdx.z into `span`-wide ranges
//     whose partial sums gmv_reduce adds in a fixed order: no atomics, so
//     the operator is the same on every call, as CG wants.
// Ragged edges are masked: rows beyond n are not written, and columns
// beyond m stage y = 0 and v = 0, so they add exactly nothing. The norms
// and the inner product share K1's FMA chain (gram_kind.cuh) on the
// prescaled inputs, so d2 is exactly 0 where x is y.
// ops/gram_matvec.py:gram_matvec_ex2_plain emulates this arithmetic.

#include "gram_matvec.cuh"

namespace {

constexpr int kThreads = 128;

// Rows per thread: as many as keep R * PC accumulators within 64
// registers, between 1 and 4. ops/gram_matvec.py:_rows_per_thread repeats
// this rule to size the column split.
template <int PC>
__host__ __device__ constexpr int rows_per_thread() {
  return 64 / PC < 1 ? 1 : 64 / PC > 4 ? 4 : 64 / PC;
}

// The factor folded into x and y: the scaled d2 (eq) or distance (the
// Matérns) is the exponent of 2. ops/gram_matvec.py:_PRESCALE repeats it.
template <int KIND>
__device__ __forceinline__ float prescale() {
  return KIND == kEq         ? 0.8493218002880191f  // sqrt(log2(e) / 2)
         : KIND == kMatern12 ? 1.4426950408889634f  // log2(e)
         : KIND == kMatern32 ? 2.4988211106473432f  // sqrt(3) log2(e)
         : KIND == kMatern52 ? 3.225964182229561f   // sqrt(5) log2(e)
                             : 1.f;
}

__device__ __forceinline__ float ex2(float a) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(a));
  return r;
}

// g of an entry from its prescaled d2 (rq and linear: unscaled).
template <int KIND>
__device__ __forceinline__ float ffma_epilogue(float d2, float inner, float alpha) {
  if (KIND == kLinear || KIND == kRq) return epilogue<KIND, float>(d2, inner, alpha);
  d2 = d2 > 0.f ? d2 : 0.f;
  if (KIND == kEq) return ex2(-d2);
  const float d = sqrtf(d2 + 1e-36f);  // sqrt(2 nu) log2(e) times the distance
  const float e = ex2(-d);
  if (KIND == kMatern12) return e;
  const float r = d * 0.6931471805599453f;  // sqrt(2 nu) times the distance
  if (KIND == kMatern32) return (1.f + r) * e;
  return (1.f + r + r * r / 3.f) * e;  // matern52
}

// D > 0: the depth is D, x rows are held in registers and y in shared
// memory. D == 0: any depth d, read from global memory per entry (the
// slow general path; the iterative path has d = 1).
template <int KIND, int D, int PC>
__global__ void __launch_bounds__(kThreads)
gmv_kernel(const float* __restrict__ x, const float* __restrict__ y, const float* __restrict__ v,
           float* __restrict__ dst, int n, int m, int d, int p, int span,
           const float* __restrict__ alpha_p) {
  const float alpha = KIND == kRq ? __ldg(alpha_p) : 1.f;  // rq's alpha, read once
  constexpr int R = rows_per_thread<PC>();
  constexpr int TM = kThreads * R;
  constexpr int DS = D > 0 ? D : 1;
  __shared__ __align__(16) float ys[kTN * DS];
  __shared__ __align__(16) float yn[kTN];
  __shared__ __align__(16) float vs[kTN * PC];

  const float c = prescale<KIND>();
  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * PC;
  const int col_begin = blockIdx.z * span;
  const int col_end = min(m, col_begin + span);

  int rows[R];
  float xr[R][DS], xn[R], acc[R][PC];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rows[r] = blockIdx.x * TM + r * kThreads + tid;
    const bool live = rows[r] < n;
    xn[r] = 0.f;
    if (D > 0) {
#pragma unroll
      for (int k = 0; k < DS; ++k) {
        xr[r][k] = live ? c * x[(size_t)rows[r] * D + k] : 0.f;
        xn[r] = fmaf(xr[r][k], xr[r][k], xn[r]);
      }
    } else if (live) {
      for (int k = 0; k < d; ++k) {
        const float xv = c * x[(size_t)rows[r] * d + k];
        xn[r] = fmaf(xv, xv, xn[r]);
      }
    }
#pragma unroll
    for (int q = 0; q < PC; ++q) acc[r][q] = 0.f;
  }

  for (int j0 = col_begin; j0 < col_end; j0 += kTN) {
    __syncthreads();  // the previous pass has finished reading ys, yn, vs
    if (D > 0) {
      for (int e = tid; e < kTN * D; e += kThreads) {
        const int j = j0 + e / D;
        ys[e] = j < col_end ? c * y[(size_t)j * D + e % D] : 0.f;
      }
    }
    for (int e = tid; e < kTN * PC; e += kThreads) {
      const int j = j0 + e / PC, q = c0 + e % PC;
      vs[e] = (j < col_end && q < p) ? v[(size_t)j * p + q] : 0.f;
    }
    __syncthreads();
    if (tid < kTN) {
      float s = 0.f;
      if (D > 0) {
#pragma unroll
        for (int k = 0; k < DS; ++k) s = fmaf(ys[tid * DS + k], ys[tid * DS + k], s);
      } else if (j0 + tid < col_end) {
        for (int k = 0; k < d; ++k) {
          const float yv = c * y[(size_t)(j0 + tid) * d + k];
          s = fmaf(yv, yv, s);
        }
      }
      yn[tid] = s;
    }
    __syncthreads();

    // Two-level sum: the pass's kTN products are summed from zero, then
    // added to the running total (a single running sum over a column
    // range of 10^5 columns drifts by ~eps per addition).
    float part[R][PC];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < PC; ++q) part[r][q] = 0.f;
#pragma unroll 4
    for (int j = 0; j < kTN; ++j) {
      const float ynj = yn[j];
      float g[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float inner = 0.f;
        if (D > 0) {
#pragma unroll
          for (int k = 0; k < DS; ++k) inner = fmaf(xr[r][k], ys[j * DS + k], inner);
        } else if (rows[r] < n && j0 + j < col_end) {
          for (int k = 0; k < d; ++k)
            inner = fmaf(c * x[(size_t)rows[r] * d + k], c * y[(size_t)(j0 + j) * d + k], inner);
        }
        g[r] = ffma_epilogue<KIND>(fmaf(-2.f, inner, xn[r] + ynj), inner, alpha);
      }
#pragma unroll
      for (int q = 0; q < PC; ++q) {
        const float vq = vs[j * PC + q];
#pragma unroll
        for (int r = 0; r < R; ++r) part[r][q] = fmaf(g[r], vq, part[r][q]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < PC; ++q) acc[r][q] += part[r][q];
  }

  float* out = dst + (size_t)blockIdx.z * n * p;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (rows[r] >= n) continue;
#pragma unroll
    for (int q = 0; q < PC; ++q)
      if (c0 + q < p) out[(size_t)rows[r] * p + c0 + q] = acc[r][q];
  }
}

template <int KIND, int D, int PC>
cudaError_t launch_main(const float* x, const float* y, const float* v, float* dst, int n, int m,
                        int d, int p, int span, int splits, const float* alpha, cudaStream_t s) {
  constexpr int TM = kThreads * rows_per_thread<PC>();
  const dim3 grid((n + TM - 1) / TM, (p + PC - 1) / PC, splits);
  gmv_kernel<KIND, D, PC><<<grid, kThreads, 0, s>>>(x, y, v, dst, n, m, d, p, span, alpha);
  return cudaGetLastError();
}

template <int KIND, int D>
cudaError_t by_width(int pc, const float* x, const float* y, const float* v, float* dst, int n,
                     int m, int d, int p, int span, int splits, const float* alpha, cudaStream_t s) {
  switch (pc) {
    case 1: return launch_main<KIND, D, 1>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 4: return launch_main<KIND, D, 4>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 8: return launch_main<KIND, D, 8>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 16: return launch_main<KIND, D, 16>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int KIND>
cudaError_t by_depth(int pc, const float* x, const float* y, const float* v, float* dst, int n,
                     int m, int d, int p, int span, int splits, const float* alpha, cudaStream_t s) {
  if (d == 1) return by_width<KIND, 1>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s);
  return by_width<KIND, 0>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s);
}

}  // namespace

// Launches K3's float32 FFMA kernel on `stream`: out (n, p) = G(x, y) @ v
// for p <= 16. `kind` follows the Kind enum of gram_kind.cuh; `pc` (1, 4,
// 8 or 16) is the output columns a thread accumulates; the column sweep
// is split into `splits` ranges of `span` columns. With splits > 1,
// `work` holds splits * n * p partial sums (else it is not read). `alpha`
// points to rq's float32 alpha on the device (null for other kinds). Returns
// cudaGetLastError() after the launches; the caller raises if it is not 0.
extern "C" int stheno_gram_matvec(int kind, const void* x_, const void* y_, const void* v_,
                                  void* out_, void* work_, int n, int m, int d, int p, int pc,
                                  int span, int splits, const void* alpha_, void* stream) {
  if ((kind == stheno::kRq && alpha_ == nullptr) || n <= 0 || m <= 0 || d <= 0 || p <= 0 || p > 16 || span <= 0 || splits <= 0 ||
      splits > 65535 || (long long)span * splits < m || (splits > 1 && work_ == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(x_);
  const float* y = static_cast<const float*>(y_);
  const float* v = static_cast<const float*>(v_);
  float* out = static_cast<float*>(out_);
  float* work = static_cast<float*>(work_);
  float* dst = splits > 1 ? work : out;
  const float* alpha = static_cast<const float*>(alpha_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case stheno::kEq: err = by_depth<stheno::kEq>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kRq: err = by_depth<stheno::kRq>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kMatern12: err = by_depth<stheno::kMatern12>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kMatern32: err = by_depth<stheno::kMatern32>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kMatern52: err = by_depth<stheno::kMatern52>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kLinear: err = by_depth<stheno::kLinear>(pc, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)reduce_splits<float>(work, out, (size_t)n * p, splits, s);
}
