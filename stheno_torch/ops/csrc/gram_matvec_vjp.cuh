// The fused Gram-gradient x V kernels and their launcher, templated on the
// element type: gram_matvec_vjp.cu instantiates float (the FFMA kernel),
// gram_matvec_vjp_f64.cu double (the FP64 tensor-core kernel), so that
// nvcc builds the two at once. See gram_matvec_vjp.cu for what the
// kernels compute and how.

#pragma once

#include <cuda_runtime.h>

#include <stddef.h>
#include <stdint.h>

#include <type_traits>

#include "gram_kind.cuh"

namespace {

using namespace stheno;

constexpr int kVjpThreads = 128;
constexpr int kVjpTN = 64;  // columns staged per pass

__device__ __forceinline__ float vjp_log(float v) { return logf(v); }
__device__ __forceinline__ double vjp_log(double v) { return log(v); }

// Rows per thread of the float32 kernel: as many as keep R (QC + 3 D)
// floats (the row of A, x, the gradient and its per-pass part) within 96
// registers, between 1 and 4. The wrapper sizes the column split by the
// rows per block it passes as VjpArgs::tm, which vjp_launch_main checks.
template <int QC, int D>
__host__ __device__ constexpr int vjp_rows() {
  return 96 / (QC + 3 * D) < 1 ? 1 : 96 / (QC + 3 * D) > 4 ? 4 : 96 / (QC + 3 * D);
}

__device__ __forceinline__ void vjp_cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void vjp_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void vjp_cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Copy pass j0's y rows (64 D values of T) and panel rows (64 QC) into one
// stage of shared memory: both are contiguous runs of whole 16-byte units
// in the padded layouts.
template <typename T, int D, int QC>
__device__ __forceinline__ void vjp_stage(T* ys, T* vs, const T* y, const T* vq, int j0,
                                          int tid) {
  constexpr int kPer = 16 / (int)sizeof(T);
  const char* ysrc = reinterpret_cast<const char*>(y + (size_t)j0 * D);
  for (int e = tid; e < kVjpTN * D / kPer; e += kVjpThreads)
    vjp_cp_async16(reinterpret_cast<char*>(ys) + 16 * e, ysrc + 16 * e);
  const char* vsrc = reinterpret_cast<const char*>(vq + (size_t)j0 * QC);
  for (int e = tid; e < kVjpTN * QC / kPer; e += kVjpThreads)
    vjp_cp_async16(reinterpret_cast<char*>(vs) + 16 * e, vsrc + 16 * e);
}

// dK/d(d2) of the five distance kinds at d2 >= 0, the arithmetic of
// ops/gram.py:_g_prime. *k receives the entry K itself (gram_kind.cuh's
// epilogue), from the same exp: for eq K = -2 g', the other kinds add
// their polynomial factor. For rq, *h also receives K (d2 / (2 alpha base)
// - log base), the entry's factor of dK/d(alpha); `hia` is 1 / (2 alpha).
template <int KIND, typename T>
__device__ __forceinline__ T g_prime(T d2, T alpha, T hia, T* k, T* h) {
  if (KIND == kEq) {
    *k = dev_exp(T(-0.5) * d2);
    return T(-0.5) * *k;
  }
  if (KIND == kRq) {
    const T base = T(1) + d2 * hia;
    const T lb = vjp_log(base);
    *k = dev_exp(-alpha * lb);
    const T ib = T(1) / base;
    *h = *k * (d2 * hia * ib - lb);
    return T(-0.5) * *k * ib;
  }
  const T d = dev_sqrt(d2 + T(1e-36));
  if (KIND == kMatern12) {
    *k = dev_exp(-d);
    return T(-0.5) * *k / d;
  }
  if (KIND == kMatern32) {
    const T r = T(1.7320508075688772) * d;
    const T e = dev_exp(-r);
    *k = (T(1) + r) * e;
    return T(-1.5) * e;
  }
  const T r = T(2.23606797749979) * d;  // matern52
  const T e = dev_exp(-r);
  *k = (T(1) + r + r * r / T(3)) * e;
  return T(-5.0 / 6.0) * (T(1) + r) * e;
}

// The entries of one (column split, q-split) slice of the output: the
// gradient (n, D), then n alpha partials when want_alpha, then n value
// partials when want_value.
__host__ __device__ __forceinline__ size_t vjp_slice(int n, int d, int want_alpha,
                                                     int want_value) {
  return (size_t)n * d + (want_alpha ? (size_t)n : 0) + (want_value ? (size_t)n : 0);
}

// The float32 kernel. One block: TM = 128 R rows of x (padded to depth D)
// and QC columns of the q-split blockIdx.y, over the columns [blockIdx.z
// span, + span) of the padded panel. y is (m_pad, D), v (qsplits, m_pad,
// QC) with zero padding; dst holds, per (column split, q-split), 2 sum_j
// W_ij (x_i - y_j) as (n, D), then, when want_alpha, the rows' alpha
// partials and, when want_value, the rows' partials of the value
// sum_j (A V^T)_ij K_ij (vjp_slice).
template <int KIND, int D, int QC>
__global__ void __launch_bounds__(kVjpThreads)
gmv_vjp_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ a, const float* __restrict__ v,
               float* __restrict__ dst, int n, int m_pad, int q, int span, float alpha,
               int want_alpha, int want_value) {
  using T = float;
  constexpr int kPer = 4;  // floats per 16 bytes
  constexpr int R = vjp_rows<QC, D>();
  constexpr int TM = kVjpThreads * R;
  constexpr int YS = kVjpTN * D;   // T of a y stage
  constexpr int VS = kVjpTN * QC;  // T of a panel stage
  static_assert(QC % kPer == 0, "a panel row must be whole 16-byte units");
  __shared__ __align__(16) T ys[2][YS];
  __shared__ __align__(16) T vs[2][VS];

  const int tid = threadIdx.x;
  const int c0 = blockIdx.y * QC;
  const int col_begin = blockIdx.z * span;
  const int col_end = min(m_pad, col_begin + span);
  const int passes = col_end > col_begin ? (col_end - col_begin) / kVjpTN : 0;
  const T* vq = v + (size_t)blockIdx.y * m_pad * QC;
  const T hia = T(0.5) / alpha;

  int rows[R];
  T xr[R][D], ar[R][QC], acc[R][D], acc_a[R], acc_v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    rows[r] = blockIdx.x * TM + r * kVjpThreads + tid;
    const bool live = rows[r] < n;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      xr[r][k] = live ? x[(size_t)rows[r] * D + k] : T(0);
      acc[r][k] = T(0);
    }
#pragma unroll
    for (int c = 0; c < QC; ++c)
      ar[r][c] = (live && c0 + c < q) ? a[(size_t)rows[r] * q + c0 + c] : T(0);
    acc_a[r] = acc_v[r] = T(0);
  }

  if (passes > 0) vjp_stage<T, D, QC>(ys[0], vs[0], y, vq, col_begin, tid);
  vjp_cp_async_commit();
  for (int p = 0; p < passes; ++p) {
    const int buf = p & 1;
    // One pass ahead: the copy of pass p + 1 runs under this pass's sweep.
    if (p + 1 < passes)
      vjp_stage<T, D, QC>(ys[buf ^ 1], vs[buf ^ 1], y, vq, col_begin + (p + 1) * kVjpTN, tid);
    vjp_cp_async_commit();
    vjp_cp_async_wait_one();  // pass p's group has landed
    __syncthreads();

    // Two-level sum, as in gram_matvec.cu: the pass's terms are summed from
    // zero, then added to the running total.
    T part[R][D], part_a[R], part_v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      part_a[r] = part_v[r] = T(0);
#pragma unroll
      for (int k = 0; k < D; ++k) part[r][k] = T(0);
    }
#pragma unroll 2
    for (int j = 0; j < kVjpTN; ++j) {
      T yj[D];
#pragma unroll
      for (int k = 0; k < D; ++k) yj[k] = ys[buf][j * D + k];
      // s_r = A_r . V_j, in kPer interleaved partial sums (shorter chains).
      T s[R][kPer];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int u = 0; u < kPer; ++u) s[r][u] = T(0);
#pragma unroll
      for (int c = 0; c < QC; c += kPer) {
        const float4 pk = *reinterpret_cast<const float4*>(&vs[buf][j * QC + c]);
        const float* pv = reinterpret_cast<const float*>(&pk);
#pragma unroll
        for (int u = 0; u < kPer; ++u)
#pragma unroll
          for (int r = 0; r < R; ++r) s[r][u] = fma(ar[r][c + u], pv[u], s[r][u]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        T sr = s[r][0];
#pragma unroll
        for (int u = 1; u < kPer; ++u) sr += s[r][u];
        T diff[D], d2 = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) {
          diff[k] = xr[r][k] - yj[k];
          d2 = fma(diff[k], diff[k], d2);
        }
        T kv, h = T(0);
        const T w = sr * g_prime<KIND, T>(d2, alpha, hia, &kv, &h);
#pragma unroll
        for (int k = 0; k < D; ++k) part[r][k] = fma(w, diff[k], part[r][k]);
        if (KIND == kRq) part_a[r] = fma(sr, h, part_a[r]);
        part_v[r] = fma(sr, kv, part_v[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      acc_a[r] += part_a[r];
      acc_v[r] += part_v[r];
#pragma unroll
      for (int k = 0; k < D; ++k) acc[r][k] += part[r][k];
    }
    __syncthreads();  // all reads of `buf` are done before pass p + 2 refills it
  }

  const size_t slice = vjp_slice(n, D, want_alpha, want_value);
  T* out = dst + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * slice;
  T* out_v = out + (size_t)n * D + (want_alpha ? (size_t)n : 0);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (rows[r] >= n) continue;
#pragma unroll
    for (int k = 0; k < D; ++k) out[(size_t)rows[r] * D + k] = T(2) * acc[r][k];
    if (want_alpha) out[(size_t)n * D + rows[r]] = acc_a[r];
    if (want_value) out_v[rows[r]] = acc_v[r];
  }
}

// D (8x8) += A (8x4, row-major) B (4x8, column-major) on the FP64 tensor
// cores. Fragments (PTX ISA, mma.m8n8k4 .f64): lane l holds A[l / 4][l %
// 4], B[l % 4][l / 4] and D[l / 4][2 (l % 4)], D[l / 4][2 (l % 4) + 1].
__device__ __forceinline__ void dmma_m8n8k4(double (&c)[2], double a, double b) {
  asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
               : "+d"(c[0]), "+d"(c[1])
               : "d"(a), "d"(b));
}

// Row groups of 8 a warp owns in the float64 kernel: 4 at depths 1 and 2,
// fewer where x and the gradient take more registers. The wrapper's rows
// per block (VjpArgs::tm) are checked against it as for vjp_rows.
template <int D>
__host__ __device__ constexpr int dmma_groups() {
  return D <= 2 ? 4 : D == 4 ? 2 : 1;
}

// The float64 kernel: the same sums as gmv_vjp_kernel, with the q-wide dots
// A_i . V_j on the FP64 tensor cores. A warp owns MR groups of 8 rows (32
// MR rows, 4 warps a block) and holds their rows of A as mma A fragments;
// per pass, each 8-column tile of the panel is one B fragment per k-step
// (one shared-memory load, reused by the MR groups), and the 8x8 tile of
// dots lands in the C fragments: each lane then owns two entries of each
// group's tile, builds their K and g' and adds their terms to its row's
// sums. The value's terms are summed from zero in each pass, and the pass
// totals added into a compensated (Kahan) sum that each lane keeps in
// shared memory (its registers are spent: 160 at the path's shape, three
// blocks per SM): the value is a total over N^2 signed terms that cancel
// far below their sizes, and a running sum of 65,536 terms per lane put
// the surrogate's value 1.4e-10 away from K3's two-level sums on the
// H100. The four lanes of a row add their sums by two shuffles at the
// end, in a fixed order.
template <int KIND, int D, int QC>
__global__ void __launch_bounds__(kVjpThreads)
gmv_vjp_dmma_kernel(const double* __restrict__ x, const double* __restrict__ y,
                    const double* __restrict__ a, const double* __restrict__ v,
                    double* __restrict__ dst, int n, int m_pad, int q, int span, double alpha,
                    int want_alpha, int want_value) {
  constexpr int MR = dmma_groups<D>();
  constexpr int KS = QC / 4;  // k-steps of the dot
  constexpr int TM = 4 * 8 * MR;
  __shared__ __align__(16) double ys[2][kVjpTN * D];
  __shared__ __align__(16) double vs[2][kVjpTN * QC];
  // The value's compensated sums: [0] the sum, [1] its compensation, one
  // slot per (warp, group, lane), each touched by its own thread only.
  __shared__ double sum_v[2][kVjpThreads * MR];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.y * QC;
  const int col_begin = blockIdx.z * span;
  const int col_end = min(m_pad, col_begin + span);
  const int passes = col_end > col_begin ? (col_end - col_begin) / kVjpTN : 0;
  const double* vq = v + (size_t)blockIdx.y * m_pad * QC;
  const double hia = 0.5 / alpha;

  int rows[MR];
  double xr[MR][D], af[MR][KS], acc[MR][D], acc_a[MR];
#pragma unroll
  for (int g = 0; g < MR; ++g) {
    rows[g] = blockIdx.x * TM + (warp * MR + g) * 8 + gid;
    sum_v[0][(warp * MR + g) * 32 + lane] = sum_v[1][(warp * MR + g) * 32 + lane] = 0.0;
    const bool live = rows[g] < n;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      xr[g][k] = live ? x[(size_t)rows[g] * D + k] : 0.0;
      acc[g][k] = 0.0;
    }
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      const int c = c0 + 4 * s + tig;
      af[g][s] = (live && c < q) ? a[(size_t)rows[g] * q + c] : 0.0;
    }
    acc_a[g] = 0.0;
  }

  if (passes > 0) vjp_stage<double, D, QC>(ys[0], vs[0], y, vq, col_begin, tid);
  vjp_cp_async_commit();
  for (int p = 0; p < passes; ++p) {
    const int buf = p & 1;
    if (p + 1 < passes)
      vjp_stage<double, D, QC>(ys[buf ^ 1], vs[buf ^ 1], y, vq, col_begin + (p + 1) * kVjpTN,
                               tid);
    vjp_cp_async_commit();
    vjp_cp_async_wait_one();  // pass p's group has landed
    __syncthreads();

    double part_v[MR];
#pragma unroll
    for (int g = 0; g < MR; ++g) part_v[g] = 0.0;
#pragma unroll 1
    for (int t = 0; t < kVjpTN / 8; ++t) {
      double c[MR][2];
#pragma unroll
      for (int g = 0; g < MR; ++g) c[g][0] = c[g][1] = 0.0;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        const double b = vs[buf][(8 * t + gid) * QC + 4 * s + tig];
#pragma unroll
        for (int g = 0; g < MR; ++g) dmma_m8n8k4(c[g], af[g][s], b);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int j = 8 * t + 2 * tig + i;
        double yj[D];
#pragma unroll
        for (int k = 0; k < D; ++k) yj[k] = ys[buf][j * D + k];
#pragma unroll
        for (int g = 0; g < MR; ++g) {
          double diff[D], d2 = 0.0;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            diff[k] = xr[g][k] - yj[k];
            d2 = fma(diff[k], diff[k], d2);
          }
          double kv, h = 0.0;
          const double w = c[g][i] * g_prime<KIND, double>(d2, alpha, hia, &kv, &h);
#pragma unroll
          for (int k = 0; k < D; ++k) acc[g][k] = fma(w, diff[k], acc[g][k]);
          if (KIND == kRq) acc_a[g] = fma(c[g][i], h, acc_a[g]);
          part_v[g] = fma(c[g][i], kv, part_v[g]);
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MR; ++g) {
      const int slot = (warp * MR + g) * 32 + lane;
      const double sum = sum_v[0][slot], yv = part_v[g] - sum_v[1][slot];
      const double t = sum + yv;
      sum_v[1][slot] = (t - sum) - yv;
      sum_v[0][slot] = t;
    }
    __syncthreads();  // all reads of `buf` are done before pass p + 2 refills it
  }

  const size_t slice = vjp_slice(n, D, want_alpha, want_value);
  double* out = dst + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * slice;
  double* out_v = out + (size_t)n * D + (want_alpha ? (size_t)n : 0);
#pragma unroll
  for (int g = 0; g < MR; ++g) {
#pragma unroll
    for (int k = 0; k < D; ++k) {
      acc[g][k] += __shfl_xor_sync(0xffffffffu, acc[g][k], 1);
      acc[g][k] += __shfl_xor_sync(0xffffffffu, acc[g][k], 2);
    }
    acc_a[g] += __shfl_xor_sync(0xffffffffu, acc_a[g], 1);
    acc_a[g] += __shfl_xor_sync(0xffffffffu, acc_a[g], 2);
    const int slot = (warp * MR + g) * 32 + lane;
    double acc_v = sum_v[0][slot] - sum_v[1][slot];
    acc_v += __shfl_xor_sync(0xffffffffu, acc_v, 1);
    acc_v += __shfl_xor_sync(0xffffffffu, acc_v, 2);
    if (tig != 0 || rows[g] >= n) continue;
#pragma unroll
    for (int k = 0; k < D; ++k) out[(size_t)rows[g] * D + k] = 2.0 * acc[g][k];
    if (want_alpha) out[(size_t)n * D + rows[g]] = acc_a[g];
    if (want_value) out_v[rows[g]] = acc_v;
  }
}

// out[i] = sum over s of part[s][i], s in order: the (column split,
// q-split) partial sums, added the same way on every call.
template <typename T>
__global__ void gmv_vjp_reduce(const T* __restrict__ part, T* __restrict__ out, size_t count,
                               int parts) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < count;
       i += (size_t)gridDim.x * blockDim.x) {
    T s = part[i];
    for (int k = 1; k < parts; ++k) s += part[(size_t)k * count + i];
    out[i] = s;
  }
}

// tm: the rows per block the wrapper sized the launch for.
struct VjpArgs {
  int n, m_pad, q, span, splits, qsplits, want_alpha, want_value, tm;
};

// float64 takes the tensor-core kernel, float32 the FFMA kernel. A launch
// whose tm is not the kernel's rows per block is refused: the wrapper's
// column split would then not fill the card as it planned.
template <int KIND, int D, int QC, typename T>
cudaError_t vjp_launch_main(const T* x, const T* y, const T* a, const T* v, T* dst,
                            const VjpArgs& g, T alpha, cudaStream_t s) {
  if constexpr (std::is_same<T, double>::value) {
    constexpr int TM = 4 * 8 * dmma_groups<D>();
    if (g.tm != TM) return cudaErrorInvalidValue;
    const dim3 grid((g.n + TM - 1) / TM, g.qsplits, g.splits);
    gmv_vjp_dmma_kernel<KIND, D, QC><<<grid, kVjpThreads, 0, s>>>(
        x, y, a, v, dst, g.n, g.m_pad, g.q, g.span, alpha, g.want_alpha, g.want_value);
  } else {
    constexpr int TM = kVjpThreads * vjp_rows<QC, D>();
    if (g.tm != TM) return cudaErrorInvalidValue;
    const dim3 grid((g.n + TM - 1) / TM, g.qsplits, g.splits);
    gmv_vjp_kernel<KIND, D, QC><<<grid, kVjpThreads, 0, s>>>(
        x, y, a, v, dst, g.n, g.m_pad, g.q, g.span, alpha, g.want_alpha, g.want_value);
  }
  return cudaGetLastError();
}

template <int KIND, int D, typename T>
cudaError_t vjp_by_width(int qc, const T* x, const T* y, const T* a, const T* v, T* dst,
                         const VjpArgs& g, T alpha, cudaStream_t s) {
  switch (qc) {
    case 4: return vjp_launch_main<KIND, D, 4, T>(x, y, a, v, dst, g, alpha, s);
    case 8: return vjp_launch_main<KIND, D, 8, T>(x, y, a, v, dst, g, alpha, s);
    case 20: return vjp_launch_main<KIND, D, 20, T>(x, y, a, v, dst, g, alpha, s);
    case 36: return vjp_launch_main<KIND, D, 36, T>(x, y, a, v, dst, g, alpha, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int KIND, typename T>
cudaError_t vjp_by_depth(int d, int qc, const T* x, const T* y, const T* a, const T* v, T* dst,
                         const VjpArgs& g, T alpha, cudaStream_t s) {
  switch (d) {
    case 1: return vjp_by_width<KIND, 1, T>(qc, x, y, a, v, dst, g, alpha, s);
    case 2: return vjp_by_width<KIND, 2, T>(qc, x, y, a, v, dst, g, alpha, s);
    case 4: return vjp_by_width<KIND, 4, T>(qc, x, y, a, v, dst, g, alpha, s);
    case 8: return vjp_by_width<KIND, 8, T>(qc, x, y, a, v, dst, g, alpha, s);
    default: return cudaErrorInvalidValue;
  }
}

// Both launches of one call: the sweep into `out` (or into `work` and then
// the fixed-order reduction into `out` when the sweep is split).
template <typename T>
cudaError_t vjp_launch(int kind, int d, int qc, const T* x, const T* y, const T* a, const T* v,
                       T* out, T* work, const VjpArgs& g, T alpha, cudaStream_t s) {
  const int parts = g.splits * g.qsplits;
  T* dst = parts > 1 ? work : out;
  cudaError_t err;
  switch (kind) {
    case kEq: err = vjp_by_depth<kEq, T>(d, qc, x, y, a, v, dst, g, alpha, s); break;
    case kRq: err = vjp_by_depth<kRq, T>(d, qc, x, y, a, v, dst, g, alpha, s); break;
    case kMatern12: err = vjp_by_depth<kMatern12, T>(d, qc, x, y, a, v, dst, g, alpha, s); break;
    case kMatern32: err = vjp_by_depth<kMatern32, T>(d, qc, x, y, a, v, dst, g, alpha, s); break;
    case kMatern52: err = vjp_by_depth<kMatern52, T>(d, qc, x, y, a, v, dst, g, alpha, s); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || parts == 1) return err;
  const size_t count = vjp_slice(g.n, d, g.want_alpha, g.want_value);
  const int blocks = (int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096);
  gmv_vjp_reduce<T><<<blocks, 256, 0, s>>>(work, out, count, parts);
  return cudaGetLastError();
}

}  // namespace
