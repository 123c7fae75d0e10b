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
// computes, in one launch, with W = gbar g'(d2), r_ij = x_i - y_j and rt =
// xt_i - yt_j,
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
// What bounds it: reading gbar and the B tangent tiles gt ((1 + B) n m
// entries: 64 MB at the flagship's 2000 x 2000, B = 3, float32). A simple
// design: the S x S grid of K1's backward (ops/gram_bwd.py:launch_shape,
// taken at depth d B), block (a, b) sweeping row group a against column
// span b in sub-tiles of 32 rows (a warp's 4 rows each) by 32 columns (a
// lane's one). Per entry, gbar is read once and d2, g', g'' (and rq's
// alpha terms) are computed once for up to 4 directions (one pass; more
// directions take more passes, each reading gbar again); gt is read once
// per direction. Then one (direction, depth) at a time the x sums go over
// the lanes (a fixed xor butterfly) and the y sums over the warps (in
// order, through shared memory), each added into the block's own slice of
// partials; rq's alpha sum is one per block and direction. The slices are
// added in a fixed order by gram_matvec.cuh's reduce_splits, so a result
// is bitwise the same from run to run. float32 and float64.

#include "gram_elem.cuh"
#include "gram_matvec.cuh"  // reduce_splits

namespace {

constexpr int kJvbRows = 4;                       // rows per thread of a sub-tile
constexpr int kJvbTM = kGramWarps * kJvbRows;     // rows of a sub-tile
constexpr int kJvbTN = 32;                        // columns of a sub-tile: a lane's one
constexpr int kJvbMaxB = 4;                       // directions per pass

// A slice of `count` entries holds the x part (batch * n * d, when
// want_x), the y part (batch * m * d, when want_y and not fold) and the
// alpha partials (batch * splits, rq with want_alpha). Block (a, b) writes
// its rows' x partials and its alpha partials (at direction * splits + a)
// into slice b, its columns' y partials into slice a at y_off, or with
// fold into slice splits + a at the x part's offset.
struct JvbArgs {
  int n, m, d, rows, span, splits, batch;
  int want_x, want_y, want_alpha, fold;
  size_t count, y_off, a_off;
};

template <int KIND, typename T, int NB>
__global__ void __launch_bounds__(kGramThreads)
gram_bwd_jvp_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ gbar,
                    const T* __restrict__ gt, const T* __restrict__ xt,
                    const T* __restrict__ yt, const T* __restrict__ alpha_p,
                    const T* __restrict__ at, T* __restrict__ dst, JvbArgs g) {
  constexpr int R = kJvbRows;
  constexpr T kScale = KIND == kLinear ? T(1) : T(2);
  __shared__ T ysum[kGramWarps][kJvbTN];
  __shared__ T asum[kGramWarps][NB];
  const T alpha = KIND == kRq ? __ldg(alpha_p) : T(1);  // rq's alpha, read once
  const T hia = T(0.5) / alpha;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a = blockIdx.y, b = blockIdx.x;
  const int r_begin = a * g.rows, r_end = min(g.n, r_begin + g.rows);
  const int c_begin = b * g.span, c_end = min(g.m, c_begin + g.span);
  const int n = g.n, m = g.m, d = g.d, batch = g.batch;
  const bool want_a = KIND == kRq && g.want_alpha;
  T* xdst = dst + (size_t)b * g.count;
  T* ydst = dst + (size_t)(g.fold ? g.splits + a : a) * g.count + g.y_off;

  if (r_begin >= r_end && g.want_y) {
    // An empty row group: its columns' y partials are zeros.
    for (int bb = 0; bb < batch; ++bb)
      for (int e = threadIdx.x; e < (c_end - c_begin) * d; e += kGramThreads)
        ydst[((size_t)bb * m + c_begin) * d + e] = T(0);
  }

  for (int b0 = 0; b0 < batch; b0 += NB) {  // the direction passes
    T aacc[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q) aacc[q] = T(0);
    T atv[NB];
#pragma unroll
    for (int q = 0; q < NB; ++q)
      atv[q] = KIND == kRq && at != nullptr && b0 + q < batch ? __ldg(at + b0 + q) : T(0);

    for (int cb = c_begin; cb < c_end; cb += kJvbTN) {
      const int c = cb + lane;
      const int cc = min(c, c_end - 1);  // columns past the edge read the last one, masked
      for (int rb = r_begin; rb < r_end; rb += kJvbTM) {
        const int r0 = rb + warp * R;
        int rows[R];
        bool ok[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          rows[i] = min(r0 + i, r_end - 1);
          ok[i] = r0 + i < r_end && c < c_end;
        }

        // The entries' cotangents, tangent cotangents and kernel terms.
        T gv[R], gtv[R][NB], gp[R], gpp[R], hv[R], gpa[R], haa[R];
        bool flat[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          gv[i] = ok[i] ? __ldg(gbar + (size_t)rows[i] * m + cc) : T(0);
#pragma unroll
          for (int q = 0; q < NB; ++q)
            gtv[i][q] = ok[i] && gt != nullptr && b0 + q < batch
                            ? __ldg(gt + ((size_t)(b0 + q) * n + rows[i]) * m + cc)
                            : T(0);
          gp[i] = gpp[i] = hv[i] = gpa[i] = haa[i] = T(0);
          flat[i] = false;
        }
        if (KIND != kLinear) {
          // d2 by K1's FMA chain (gram.cu), then g', g'' and rq's terms.
          T xn[R], yn = T(0), acc[R];
#pragma unroll
          for (int i = 0; i < R; ++i) xn[i] = acc[i] = T(0);
          for (int k = 0; k < d; ++k) {
            const T yv = __ldg(y + (size_t)cc * d + k);
            yn = fma(yv, yv, yn);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const T xv = __ldg(x + (size_t)rows[i] * d + k);
              xn[i] = fma(xv, xv, xn[i]);
              acc[i] = fma(xv, yv, acc[i]);
            }
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {
            T d2 = xn[i] + yn - T(2) * acc[i];
            flat[i] = d2 < T(0);
            d2 = flat[i] ? T(0) : d2;
            gpp[i] = g_second<KIND, T>(d2, alpha, hia, &gp[i], &hv[i], &gpa[i], &haa[i]);
          }
        }

        // s = <r, rt> per direction, then W' and the alpha terms.
        T wd[R][NB];
        if (KIND != kLinear) {
          T s[R][NB];
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int q = 0; q < NB; ++q) s[i][q] = T(0);
          for (int k = 0; k < d; ++k) {
            const T yv = __ldg(y + (size_t)cc * d + k);
#pragma unroll
            for (int q = 0; q < NB; ++q) {
              if (b0 + q >= batch) break;
              const T yd = yt == nullptr ? T(0) : __ldg(yt + ((size_t)(b0 + q) * m + cc) * d + k);
#pragma unroll
              for (int i = 0; i < R; ++i) {
                const T xv = __ldg(x + (size_t)rows[i] * d + k);
                const T xd =
                    xt == nullptr ? T(0) : __ldg(xt + ((size_t)(b0 + q) * n + rows[i]) * d + k);
                s[i][q] = fma(xv - yv, xd - yd, s[i][q]);
              }
            }
          }
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int q = 0; q < NB; ++q) {
              const T dd2 = flat[i] ? T(0) : T(2) * s[i][q];
              T t = gtv[i][q] * gp[i];
              if (dd2 != T(0)) t += gv[i] * gpp[i] * dd2;
              if (KIND == kRq) t += gv[i] * gpa[i] * atv[q];
              wd[i][q] = ok[i] ? t : T(0);
              if (want_a && ok[i]) {
                T e = gtv[i][q] * hv[i] + gv[i] * haa[i] * atv[q];
                if (dd2 != T(0)) e += gv[i] * gpa[i] * dd2;
                aacc[q] += e;
              }
            }
        }

        // The sums, one (direction, depth) at a time.
        for (int k = 0; k < d; ++k) {
          const T yv = __ldg(y + (size_t)cc * d + k);
          T xv[R];
#pragma unroll
          for (int i = 0; i < R; ++i) xv[i] = __ldg(x + (size_t)rows[i] * d + k);
#pragma unroll
          for (int q = 0; q < NB; ++q) {
            if (b0 + q >= batch) break;
            const T yd = yt == nullptr ? T(0) : __ldg(yt + ((size_t)(b0 + q) * m + cc) * d + k);
            T tx[R], ty = T(0);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              const T xd =
                  xt == nullptr ? T(0) : __ldg(xt + ((size_t)(b0 + q) * n + rows[i]) * d + k);
              if (KIND == kLinear) {
                tx[i] = ok[i] ? gtv[i][q] * yv + gv[i] * yd : T(0);
                ty += ok[i] ? gtv[i][q] * xv[i] + gv[i] * xd : T(0);
              } else {
                const T w = gv[i] * gp[i];
                tx[i] = ok[i] ? fma(wd[i][q], xv[i] - yv, w * (xd - yd)) : T(0);
                ty -= tx[i];
              }
            }
            if (g.want_x) {
              // The warp's lanes share its rows: sum over them, and lane i
              // adds row i's into the block's slice.
#pragma unroll
              for (int i = 0; i < R; ++i)
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                  tx[i] += __shfl_xor_sync(0xffffffffu, tx[i], o);
#pragma unroll
              for (int i = 0; i < R; ++i)
                if (lane == i && r0 + i < r_end) {
                  T* p = xdst + ((size_t)(b0 + q) * n + r0 + i) * d + k;
                  *p = (cb == c_begin ? T(0) : *p) + kScale * tx[i];
                }
            }
            if (g.want_y) {
              // The warps share the sub-tile's columns: sum over them in order.
              ysum[warp][lane] = ty;
              __syncthreads();
              if (threadIdx.x < kJvbTN && cb + (int)threadIdx.x < c_end) {
                T sy = ysum[0][threadIdx.x];
#pragma unroll
                for (int w2 = 1; w2 < kGramWarps; ++w2) sy += ysum[w2][threadIdx.x];
                T* p = ydst + ((size_t)(b0 + q) * m + cb + threadIdx.x) * d + k;
                *p = (rb == r_begin ? T(0) : *p) + kScale * sy;
              }
              __syncthreads();
            }
          }
        }
      }
    }

    if (want_a) {
#pragma unroll
      for (int q = 0; q < NB; ++q) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) aacc[q] += __shfl_xor_sync(0xffffffffu, aacc[q], o);
        if (lane == 0) asum[warp][q] = aacc[q];
      }
      __syncthreads();
      if (threadIdx.x < NB && b0 + (int)threadIdx.x < batch) {
        const int q = threadIdx.x;
        T sa = asum[0][q];
#pragma unroll
        for (int w2 = 1; w2 < kGramWarps; ++w2) sa += asum[w2][q];
        const size_t e = g.a_off + (size_t)(b0 + q) * g.splits + a;
        dst[(size_t)b * g.count + e] = sa;
        if (g.fold) dst[(size_t)(g.splits + b) * g.count + e] = T(0);
      }
      __syncthreads();
    }
  }
}

template <int KIND, typename T>
void jvb_passes(int nb, const T* x, const T* y, const T* gbar, const T* gt, const T* xt,
                const T* yt, const T* alpha, const T* at, T* dst, const JvbArgs& g,
                cudaStream_t s) {
  const dim3 grid(g.splits, g.splits);
#define STHENO_JVB(NB)                                                                    \
  gram_bwd_jvp_kernel<KIND, T, NB><<<grid, kGramThreads, 0, s>>>(x, y, gbar, gt, xt, yt, \
                                                                  alpha, at, dst, g)
  switch (nb) {
    case 1: STHENO_JVB(1); break;
    case 2: STHENO_JVB(2); break;
    case 3: STHENO_JVB(3); break;
    default: STHENO_JVB(kJvbMaxB); break;
  }
#undef STHENO_JVB
}

// Both launches of one call: the sweep into `out` (or into `work`, then
// the fixed-order sum of its slices into `out`, when there are several).
template <typename T>
cudaError_t jvb_launch(int kind, const void* xp, const void* yp, const void* gp,
                       const void* gtp, const void* xtp, const void* ytp, const void* alphap,
                       const void* atp, void* outp, void* workp, const JvbArgs& g,
                       cudaStream_t s) {
  const T* x = static_cast<const T*>(xp);
  const T* y = static_cast<const T*>(yp);
  const T* gbar = static_cast<const T*>(gp);
  const T* gt = static_cast<const T*>(gtp);
  const T* xt = static_cast<const T*>(xtp);
  const T* yt = static_cast<const T*>(ytp);
  const T* alpha = static_cast<const T*>(alphap);
  const T* at = static_cast<const T*>(atp);
  const int slices = g.fold ? 2 * g.splits : g.splits;
  T* dst = static_cast<T*>(slices > 1 ? workp : outp);
  const int nb = g.batch < kJvbMaxB ? g.batch : kJvbMaxB;
  switch (kind) {
    case kEq: jvb_passes<kEq, T>(nb, x, y, gbar, gt, xt, yt, alpha, at, dst, g, s); break;
    case kRq: jvb_passes<kRq, T>(nb, x, y, gbar, gt, xt, yt, alpha, at, dst, g, s); break;
    case kMatern12: jvb_passes<kMatern12, T>(nb, x, y, gbar, gt, xt, yt, alpha, at, dst, g, s); break;
    case kMatern32: jvb_passes<kMatern32, T>(nb, x, y, gbar, gt, xt, yt, alpha, at, dst, g, s); break;
    case kMatern52: jvb_passes<kMatern52, T>(nb, x, y, gbar, gt, xt, yt, alpha, at, dst, g, s); break;
    case kLinear: jvb_passes<kLinear, T>(nb, x, y, gbar, gt, xt, yt, alpha, at, dst, g, s); break;
    default: return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  return reduce_splits<T>(static_cast<const T*>(workp), static_cast<T*>(outp), g.count, slices,
                          s);
}

}  // namespace

// Launches the forward rule of K1's backward on `stream`. `kind` follows
// the Kind enum of gram_kind.cuh, `dtype` the DtypeCode of gram_elem.cuh
// (float32 or float64: every pointer of it). x (n, d), y (m, d), gbar (n,
// m); gt (batch, n, m), xt (batch, n, d), yt (batch, m, d) and at (batch)
// may be null (no tangent); `alpha` points to rq's alpha on the device
// (null for the other kinds). The S x S grid (S = splits) of row groups
// of `rows` and column spans of `span` (ops/gram_bwd.py:launch_shape). out
// holds the x part (batch n d, when want_x), the y part (batch m d, when
// want_y and not fold) and batch S alpha partials (rq with want_alpha);
// with fold (x is y and xt is yt, want_x) the x part is the sum of both
// roles. work holds S such slices (2 S with fold) when there are several.
// Returns cudaGetLastError() after the launches; the caller raises if it
// is not 0.
extern "C" int stheno_gram_bwd_jvp(int kind, int dtype, const void* x, const void* y,
                                   const void* gbar, const void* gt, const void* xt,
                                   const void* yt, const void* alpha, const void* at, void* out,
                                   void* work, int batch, int n, int m, int d, int rows,
                                   int span, int splits, int want_x, int want_y, int want_alpha,
                                   int fold, void* stream) {
  want_alpha = want_alpha && kind == kRq;
  if (fold) want_y = 1;
  if (batch <= 0 || n <= 0 || m <= 0 || d <= 0 || (dtype != kF32 && dtype != kF64) ||
      splits <= 0 || splits > 65535 || rows <= 0 || span <= 0 ||
      (long long)rows * splits < n || (long long)span * splits < m ||
      (long long)span * (splits - 1) >= m || (fold && (n != m || !want_x)) ||
      (kind == kRq && alpha == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t nx = want_x ? (size_t)batch * n * d : 0;
  const size_t ny = want_y && !fold ? (size_t)batch * m * d : 0;
  const size_t na = want_alpha ? (size_t)batch * splits : 0;
  const int slices = fold ? 2 * splits : splits;
  if (slices > 1 && work == nullptr) return (int)cudaErrorInvalidValue;
  const JvbArgs g{n, m, d, rows, span, splits, batch, want_x, want_y, want_alpha, fold,
                  nx + ny + na, fold ? 0 : nx, nx + ny};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)jvb_launch<float>(kind, x, y, gbar, gt, xt, yt, alpha, at, out, work, g, s);
  return (int)jvb_launch<double>(kind, x, y, gbar, gt, xt, yt, alpha, at, out, work, g, s);
}
