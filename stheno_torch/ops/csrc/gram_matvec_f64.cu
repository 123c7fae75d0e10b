// Fused Gram x V kernel (K3) for Hopper, sm_90a: float64 on the FP64
// tensor cores.
//
// Replaces, with gram_matvec.cu and gram_matvec_mma.cu (float32), the
// Pallas kernel stheno_tpu/ops/gram_matvec.py:_gmv_kernel for float64
// models: their CG (p = 17 at the N=262,144 path's shape), their weights
// (p = 1) and their queries. out = G @ v with G[i, j] = g(||x_i -
// y_j||^2) (or x_i.y_j for linear), G never stored.
//
// What bounds it: float64 has no special-function unit, so every entry's
// distance and exp run on the FP64 units (64 lanes per clock per SM), and
// so would its p products on DFMA. Here the products go to the FP64
// tensor cores (mma.m16n8k16.f64), and what stays on the FP64 units per
// entry is the distance chain (3 operations) and the exp below (13): the
// floor of this design, about 6.9e10 entries x 16 operations at the
// N=262,144 shape. (The FFMA kernel it replaces padded p = 17 to 32
// columns and spent 32 DFMAs per entry on the products, beside
// libdevice's general exp.)
//
// Design:
//   - a warp owns 16 rows, a block four warps (64 rows), and W output
//     columns: p padded to a multiple of 8 (8, 16, 24, 32 or 64; wider p
//     splits over blockIdx.y in blocks of 64), except that p = 8 k + 1 up
//     to 33 (the CG's 17, the weights' 1) takes its last column on DFMA,
//     one FMA per entry, instead of a tile of 8 on the tensor cores;
//   - each Gram entry is built in float64 in the register that is its own
//     A fragment of mma.m16n8k16.f64: per k-step of 16 columns, lane l =
//     4 g + t builds the 8 entries (rows g and g + 8 of its warp, columns
//     t, t + 4, t + 8 and t + 12 of the k-step), which NB / 8 mma then
//     multiply by the k-step's 16 x 8 slices of v. The 8 entries are
//     independent chains the scheduler interleaves. Per pass, kTN columns
//     of y (with |y|^2) are staged in shared memory, and v's slice in
//     B-fragment order (8-byte loads, a warp's 32 consecutive);
//   - the 16 x 8 output tiles stay in registers as C, the DFMA column as
//     each lane's sums over its columns, which the four lanes of a row add
//     at the end in a fixed order; each pass sums its products from zero,
//     then adds them to the running total (the two-level sum of
//     gram_matvec.cu);
//   - the distance is K1's FMA chain (gram_kind.cuh), so d2 is exactly 0
//     where x is y; the epilogue is gram_kind.cuh's with exp_neg_half, an
//     exp for the arguments it takes, without branches;
//   - where rows are few the column sweep splits over blockIdx.z and
//     gmv_reduce adds the parts in a fixed order. No atomics: the
//     operator is the same on every call, as CG wants.
// Ragged edges are masked: rows beyond n are not written, and columns
// beyond m stage y = 0 and v = 0, so they add exactly nothing.

#include <stdint.h>

#include "gram_matvec.cuh"

namespace {

constexpr int kDmmaThreads = 128;  // four warps

// 2^(k / 32) for k < 32, each as a double and the remainder: exp_neg_half's
// table (to 2^-105).
__constant__ double2 kExp2Table[32] = {
    {1.0, 0.0}, {1.0218971486541166, 5.109225028973444e-17},
    {1.0442737824274138, 8.551889705537965e-17}, {1.0671404006768237, -7.899853966841582e-17},
    {1.0905077326652577, -3.046782079812471e-17}, {1.1143867425958924, 1.0410278456845571e-16},
    {1.1387886347566916, 8.912812676025408e-17}, {1.1637248587775775, 3.8292048369240935e-17},
    {1.189207115002721, 3.982015231465646e-17}, {1.215247359980469, -7.712630692681488e-17},
    {1.241857812073484, 4.658027591836937e-17}, {1.2690509571917332, 2.667932131342186e-18},
    {1.2968395546510096, 2.5382502794888315e-17}, {1.3252366431597413, -2.8587312100388614e-17},
    {1.3542555469368927, 7.70094837980299e-17}, {1.383909881963832, -6.770511658794786e-17},
    {1.4142135623730951, -9.667293313452913e-17}, {1.4451808069770467, -3.0237581349939873e-17},
    {1.4768261459394993, -3.483994556892796e-17}, {1.5091644275934228, -1.016455327754295e-16},
    {1.5422108254079407, 7.949834809697621e-17}, {1.5759808451078865, -1.0136916471278304e-17},
    {1.6104903319492543, 2.4707192569797888e-17}, {1.645755478153965, -1.0125679913674773e-16},
    {1.681792830507429, 8.199010020581497e-17}, {1.718619298122478, -1.851380418263111e-17},
    {1.7562521603732995, 2.960140695448873e-17}, {1.7947090750031072, 1.8227458427912087e-17},
    {1.8340080864093424, 3.283107224245627e-17}, {1.8741676341103, -6.122763413004143e-17},
    {1.9152065613971474, -1.0619946056195963e-16}, {1.9571441241754002, 8.960767791036668e-17},
};

// exp(-u / 2) for the epilogue's u = d2 (or twice a Matérn's scaled
// distance), u >= 0: u < 0 (rounding) counts as 0 and u >= 1500 as about
// 1500, whose exp rounds to 0; both clamps act on u's high word, off the
// FP64 units. N = rint(-16 log2(e) u) by the 1.5 2^52 shifter (its low word is
// N); r = -u - N ln2 / 16, twice the reduced argument, in two steps
// (Cody-Waite: ln2's high part has 32 trailing zero bits, so N ln2_hi / 16
// is exact), |r| <= ln2 / 32; exp(r / 2) - 1 by its Taylor polynomial of
// degree 6 (truncation 3.4e-18) on DFMA; times 2^(N % 32 / 32) from the
// table in shared memory (hi and lo parts: one FMA and one add), then
// 2^(N / 32): added to the exponent field down to 2^-1021, the rest by
// one product, which rounds once, also into the subnormals. Within 0.71
// ulp of the exact exp on 7,500 points of [-745.2, 0] in an emulation of
// these FMAs; chip_smoke.py holds it to torch.exp on the card. No branch:
// the scheduler interleaves a thread's exps.
__device__ __forceinline__ double exp_neg_half(double u, const double2* tab) {
  constexpr double kShift = 6755399441055744.0;  // 1.5 2^52
  // Clamp u's high word to [0, that of 1500]: a negative u becomes a
  // subnormal (exp 1), a large one about 1500 (exp 0).
  u = __hiloint2double(min(max(__double2hiint(u), 0), 0x40977000), __double2loint(u));
  const double t = fma(u, -23.083120654223414, kShift);  // -16 log2(e)
  const double nd = t - kShift;
  double r = fma(nd, -0.04332169877307024, -u);  // ln2_hi / 16
  r = fma(nd, -1.1926343307941173e-11, r);       // ln2_lo / 16
  double q = 2.170138888888889e-05;               // 1 / (2^6 6!)
  q = fma(q, r, 0.00026041666666666666);
  q = fma(q, r, 0.0026041666666666665);
  q = fma(q, r, 0.020833333333333332);
  q = fma(q, r, 0.125);
  q = fma(q, r, 0.5);
  q *= r;
  const int n = __double2loint(t);
  const double2 tk = tab[n & 31];
  const double e = fma(tk.x, q, tk.y) + tk.x;
  const int m = n >> 5, k = max(m, -1021);
  return __hiloint2double(__double2hiint(e) + k * (1 << 20), __double2loint(e)) *
         __hiloint2double((m - k + 1023) << 20, 0);
}

// gram_kind.cuh's epilogue in float64 with exp_neg_half for dev_exp.
template <int KIND>
__device__ __forceinline__ double dmma_epilogue(double d2, double inner, double alpha,
                                                const double2* tab) {
  if (KIND == kLinear || KIND == kRq) return epilogue<KIND, double>(d2, inner, alpha);
  if (KIND == kEq) return exp_neg_half(d2, tab);
  d2 = d2 > 0.0 ? d2 : 0.0;
  const double d = sqrt(d2 + 1e-36);
  if (KIND == kMatern12) return exp_neg_half(d + d, tab);
  if (KIND == kMatern32) {
    const double r = 1.7320508075688772 * d;
    return (1.0 + r) * exp_neg_half(r + r, tab);
  }
  const double r = 2.23606797749979 * d;  // matern52
  return (1.0 + r + r * r / 3.0) * exp_neg_half(r + r, tab);
}

// D (16x8) += A (16x16, row-major) B (16x8, column-major) on the FP64
// tensor cores. Fragments (PTX ISA, mma.m16n8k16 .f64), lane l = 4 g + t:
// a[i] = A[g + 8 (i % 2)][t + 4 (i / 2)], b[i] = B[t + 4 i][g] and c[i] =
// D[g + 8 (i / 2)][2 t + i % 2].
__device__ __forceinline__ void dmma_m16n8k16(double (&c)[4], const double (&a)[8],
                                              const double (&b)[4]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]), "d"(a[7]),
        "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

constexpr int kKm = 16;                 // columns of G per k-step (the mma's k)
constexpr int kDmmaRows = 16 * kDmmaThreads / 32;  // rows per block: 16 a warp

// D > 0: depth D, x in registers and y staged; D == 0: any depth d, read
// from global memory per entry (the general path; the iterative path has
// d = 1).
template <int KIND, int D, int W>
__global__ void __launch_bounds__(kDmmaThreads)
gmv_dmma_kernel(const double* __restrict__ x, const double* __restrict__ y,
                const double* __restrict__ v, double* __restrict__ dst, int n, int m, int d,
                int p, int span, double alpha) {
  constexpr int RC = W % 8 == 1;   // the last column on DFMA
  constexpr int NB = W - RC;       // columns on the tensor cores
  constexpr int NT = NB / 8;       // their 8-column tiles
  constexpr int NTA = NT > 0 ? NT : 1;
  constexpr int KS = kTN / kKm;    // k-steps per pass
  constexpr int DS = D > 0 ? D : 1;
  __shared__ __align__(16) double ys[kTN * DS];
  __shared__ __align__(16) double yn[kTN];
  __shared__ __align__(16) double vs[KS * NTA * 4 * 32];  // B fragments: [k-step][tile][i][lane]
  __shared__ __align__(16) double vr[RC ? kTN : 1];        // the DFMA column
  __shared__ double2 tab[32];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int c0 = blockIdx.y * W;
  const int col_begin = blockIdx.z * span;
  const int col_end = min(m, col_begin + span);
  if (tid < 32) tab[tid] = kExp2Table[tid];  // read after the pass loop's first barrier

  int rows[2];
  double xr[2][DS], xn[2], acc[NTA][4], acc_r[2] = {0.0, 0.0};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = blockIdx.x * kDmmaRows + warp * 16 + 8 * h + gid;
    const bool live = rows[h] < n;
    xn[h] = 0.0;
    if (D > 0) {
#pragma unroll
      for (int k = 0; k < DS; ++k) {
        xr[h][k] = live ? x[(size_t)rows[h] * D + k] : 0.0;
        xn[h] = fma(xr[h][k], xr[h][k], xn[h]);
      }
    } else if (live) {
      for (int k = 0; k < d; ++k) {
        const double xv = x[(size_t)rows[h] * d + k];
        xn[h] = fma(xv, xv, xn[h]);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[t][i] = 0.0;

  for (int j0 = col_begin; j0 < col_end; j0 += kTN) {
    __syncthreads();  // the previous pass has finished reading ys, yn, vs
    if (D > 0) {
      for (int e = tid; e < kTN * D; e += kDmmaThreads) {
        const int j = j0 + e / D;
        ys[e] = j < col_end ? y[(size_t)j * D + e % D] : 0.0;
      }
    }
    for (int e = tid; e < KS * NT * 4 * 32; e += kDmmaThreads) {
      // b[i] of k-step s and tile t, for lane l = 4 g + t'.
      const int l = e & 31, i = (e >> 5) & 3, t = (e >> 7) % NTA, s = (e >> 7) / NTA;
      const int j = j0 + kKm * s + (l & 3) + 4 * i, c = c0 + 8 * t + (l >> 2);
      vs[e] = (j < col_end && c < p) ? v[(size_t)j * p + c] : 0.0;
    }
    if (RC) {
      for (int e = tid; e < kTN; e += kDmmaThreads)
        vr[e] = j0 + e < col_end ? v[(size_t)(j0 + e) * p + c0 + NB] : 0.0;
    }
    __syncthreads();
    if (tid < kTN) {
      double s = 0.0;
      if (D > 0) {
#pragma unroll
        for (int k = 0; k < DS; ++k) s = fma(ys[tid * DS + k], ys[tid * DS + k], s);
      } else if (j0 + tid < col_end) {
        for (int k = 0; k < d; ++k) {
          const double yv = y[(size_t)(j0 + tid) * d + k];
          s = fma(yv, yv, s);
        }
      }
      yn[tid] = s;
    }
    __syncthreads();

    double part[NTA][4], part_r[2] = {0.0, 0.0};
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[t][i] = 0.0;
#pragma unroll 1
    for (int s = 0; s < KS; ++s) {
      double a[8];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int jl = kKm * s + tig + 4 * c;  // this lane's column c of the k-step
        const double ynj = yn[jl];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          double inner = 0.0;
          if (D > 0) {
#pragma unroll
            for (int k = 0; k < DS; ++k) inner = fma(xr[h][k], ys[jl * DS + k], inner);
          } else if (rows[h] < n && j0 + jl < col_end) {
            for (int k = 0; k < d; ++k)
              inner = fma(x[(size_t)rows[h] * d + k], y[(size_t)(j0 + jl) * d + k], inner);
          }
          a[2 * c + h] = dmma_epilogue<KIND>(fma(-2.0, inner, xn[h] + ynj), inner, alpha, tab);
        }
      }
      if (RC) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const double vc = vr[kKm * s + tig + 4 * c];
          part_r[0] = fma(a[2 * c], vc, part_r[0]);
          part_r[1] = fma(a[2 * c + 1], vc, part_r[1]);
        }
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        double b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) b[i] = vs[((s * NT + t) * 4 + i) * 32 + lane];
        dmma_m16n8k16(part[t], a, b);
      }
    }
#pragma unroll
    for (int t = 0; t < NT; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[t][i] += part[t][i];
    acc_r[0] += part_r[0];
    acc_r[1] += part_r[1];
  }

  double* out = dst + (size_t)blockIdx.z * n * p;
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = rows[i / 2], c = c0 + 8 * t + 2 * tig + i % 2;
      if (row < n && c < p) out[(size_t)row * p + c] = acc[t][i];
    }
  if (RC) {
    // The DFMA column: the four lanes of a row add their columns' sums, in
    // a fixed order.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      double r = acc_r[h];
      r += __shfl_xor_sync(0xffffffffu, r, 1);
      r += __shfl_xor_sync(0xffffffffu, r, 2);
      if (tig == 0 && rows[h] < n) out[(size_t)rows[h] * p + c0 + NB] = r;
    }
  }
}

template <int KIND, int D, int W>
cudaError_t dmma_launch_main(const double* x, const double* y, const double* v, double* dst,
                             int n, int m, int d, int p, int span, int splits, double alpha,
                             cudaStream_t s) {
  if (W % 8 == 1 && p != W) return cudaErrorInvalidValue;  // a DFMA column ends p
  const dim3 grid((n + kDmmaRows - 1) / kDmmaRows, (p + W - 1) / W, splits);
  gmv_dmma_kernel<KIND, D, W><<<grid, kDmmaThreads, 0, s>>>(x, y, v, dst, n, m, d, p, span,
                                                            alpha);
  return cudaGetLastError();
}

template <int KIND, int D>
cudaError_t dmma_by_width(int nb, const double* x, const double* y, const double* v, double* dst,
                          int n, int m, int d, int p, int span, int splits, double alpha,
                          cudaStream_t s) {
  switch (nb) {
    case 1: return dmma_launch_main<KIND, D, 1>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 8: return dmma_launch_main<KIND, D, 8>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 9: return dmma_launch_main<KIND, D, 9>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 16: return dmma_launch_main<KIND, D, 16>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 17: return dmma_launch_main<KIND, D, 17>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 24: return dmma_launch_main<KIND, D, 24>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 25: return dmma_launch_main<KIND, D, 25>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 32: return dmma_launch_main<KIND, D, 32>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 33: return dmma_launch_main<KIND, D, 33>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    case 64: return dmma_launch_main<KIND, D, 64>(x, y, v, dst, n, m, d, p, span, splits, alpha, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int KIND>
cudaError_t dmma_by_depth(int nb, const double* x, const double* y, const double* v, double* dst,
                          int n, int m, int d, int p, int span, int splits, double alpha,
                          cudaStream_t s) {
  if (d == 1) return dmma_by_width<KIND, 1>(nb, x, y, v, dst, n, m, d, p, span, splits, alpha, s);
  return dmma_by_width<KIND, 0>(nb, x, y, v, dst, n, m, d, p, span, splits, alpha, s);
}

}  // namespace

// Launches K3's float64 kernel on `stream`: out (n, p) = G(x, y) @ v.
// `kind` follows the Kind enum of gram_kind.cuh; `nb` (8, 16, 24, 32 or
// 64) is the output columns a block holds; the column sweep is split into
// `splits` ranges of `span` columns. With splits > 1, `work` holds
// splits * n * p partial sums (else it is not read). Returns
// cudaGetLastError() after the launches; the caller raises if it is not 0.
extern "C" int stheno_gram_matvec_dmma(int kind, const void* x_, const void* y_, const void* v_,
                                       void* out_, void* work_, int n, int m, int d, int p,
                                       int nb, int span, int splits, double alpha,
                                       void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || p <= 0 || span <= 0 || splits <= 0 || splits > 65535 ||
      (long long)span * splits < m || (splits > 1 && work_ == nullptr))
    return (int)cudaErrorInvalidValue;
  const double* x = static_cast<const double*>(x_);
  const double* y = static_cast<const double*>(y_);
  const double* v = static_cast<const double*>(v_);
  double* out = static_cast<double*>(out_);
  double* work = static_cast<double*>(work_);
  double* dst = splits > 1 ? work : out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (kind) {
    case stheno::kEq: err = dmma_by_depth<stheno::kEq>(nb, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kRq: err = dmma_by_depth<stheno::kRq>(nb, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kMatern12: err = dmma_by_depth<stheno::kMatern12>(nb, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kMatern32: err = dmma_by_depth<stheno::kMatern32>(nb, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kMatern52: err = dmma_by_depth<stheno::kMatern52>(nb, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kLinear: err = dmma_by_depth<stheno::kLinear>(nb, x, y, v, dst, n, m, d, p, span, splits, alpha, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)reduce_splits<double>(work, out, (size_t)n * p, splits, s);
}
