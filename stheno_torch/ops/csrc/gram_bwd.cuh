// K1's backward kernel and its launcher, templated on the storage type:
// gram_bwd.cu instantiates float32 and bfloat16 (and holds the C entry
// point), gram_bwd_f64.cu float64, so that nvcc builds the two at once.
// See gram_bwd.cu for what it computes and how.

#pragma once

#include "gram_elem.cuh"
#include "gram_matvec.cuh"  // reduce_splits

namespace stheno {

// One launch. The grid is splits x splits blocks: block (a, b) sweeps the
// rows [a rows, + rows) against the columns [b span, + span). A slice of
// `count` entries holds the x part (n * d, when want_x), the y part (m *
// d, when want_y and not fold) and `splits` alpha partials (rq with
// want_alpha). Block (a, b) writes its rows' x partials and its alpha
// partial (at a) into slice b, its columns' y partials into slice a, or
// with fold (x is y) into slice splits + a at the x part's offset, so that
// one fixed-order sum of the 2 splits slices adds both roles.
struct BwdArgs {
  int n, m, d, rows, span, splits;
  int want_x, want_y, want_alpha, fold, vec_ok;
  size_t count, y_off, a_off;
};

}  // namespace stheno

namespace {

// Rows per thread of a (TM, TN) sub-tile, kVec columns each: 4 at depths
// 1 and 2, else 2; half that for bfloat16, whose 16 bytes are 8 columns.
template <typename S, int D>
constexpr int kBwdRows = ((D == 1 || D == 2) ? 4 : 2) / (sizeof(S) == 2 ? 2 : 1);

template <int KIND, typename S, int D>
__global__ void __launch_bounds__(kGramThreads, 2)
gram_bwd_kernel(const S* __restrict__ x, const S* __restrict__ y, const S* __restrict__ gbar,
                typename Arith<S>::T* __restrict__ dst, BwdArgs g,
                const typename Arith<S>::T* __restrict__ alpha_p) {
  using T = typename Arith<S>::T;
  const T alpha = KIND == kRq ? __ldg(alpha_p) : T(1);  // rq's alpha, read once
  constexpr int V = kVec<S>, R = kBwdRows<S, D>, TM = kGramWarps * R, TN = 32 * V;
  constexpr int DC = D == 0 ? 8 : D;  // depth per pass
  constexpr T kScale = KIND == kLinear ? T(1) : T(2);
  __shared__ T ysum[kGramWarps][TN];
  __shared__ T asum[kGramWarps];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a = blockIdx.y, b = blockIdx.x;
  const int r_begin = a * g.rows, r_end = min(g.n, r_begin + g.rows);
  const int c_begin = b * g.span, c_end = min(g.m, c_begin + g.span);
  const int d = g.d, m = g.m;
  const int depth = D == 0 ? d : D;
  const T hia = T(0.5) / alpha;
  T* xdst = dst + (size_t)b * g.count;
  T* ydst = dst + (size_t)(g.fold ? g.splits + a : a) * g.count + g.y_off;
  T alpha_acc = T(0);

  for (int cb = c_begin; cb < c_end; cb += TN) {
    const int c0 = cb + lane * V;
    int cols[V];  // columns past the edge read the last one, with gbar 0
#pragma unroll
    for (int j = 0; j < V; ++j) cols[j] = min(c0 + j, c_end - 1);
    // D > 0: the columns at full depth, for the distance and the gradient.
    // D = 0: the gradient's depth slice, loaded per pass below.
    T yv[V][DC], yn[V];
#pragma unroll
    for (int j = 0; j < V; ++j) yn[j] = T(0);
    if constexpr (D > 0) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        load_depth<DC>(y + (size_t)cols[j] * d, d, yv[j]);
#pragma unroll
        for (int k = 0; k < DC; ++k) yn[j] = fma(yv[j][k], yv[j][k], yn[j]);
      }
    }

    for (int k0 = 0; k0 < depth; k0 += DC) {  // the gradient's depth passes
      if constexpr (D == 0) {
#pragma unroll
        for (int j = 0; j < V; ++j) load_depth<DC>(y + (size_t)cols[j] * d + k0, d - k0, yv[j]);
      }
      T yacc[V][DC];
#pragma unroll
      for (int j = 0; j < V; ++j)
#pragma unroll
        for (int k = 0; k < DC; ++k) yacc[j][k] = T(0);

      // At depths 1 and 2, two sub-tiles at a time: the next one's loads go
      // out before this one's sums (deeper, the registers would spill).
#pragma unroll((D == 1 || D == 2) ? 2 : 1)
      for (int rb = r_begin; rb < r_end; rb += TM) {
        const int r0 = rb + warp * R;
        int rows[R];
#pragma unroll
        for (int i = 0; i < R; ++i) rows[i] = min(r0 + i, r_end - 1);

        // The cotangent, 0 past the edges: those entries add nothing.
        T gv[R][V];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const bool row_ok = r0 + i < r_end;
          const S* gp = gbar + (size_t)rows[i] * m + c0;
          if (row_ok && g.vec_ok && c0 + V <= c_end) {
            S t[V];
            load16(gp, t);
#pragma unroll
            for (int j = 0; j < V; ++j) gv[i][j] = to_arith(t[j]);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j)
              gv[i][j] = row_ok && c0 + j < c_end ? to_arith(__ldg(gp + j)) : T(0);
          }
        }

        // Each entry's d2, by the forward's FMA chain (gram.cu), and W.
        T xv[R][DC], w[R][V];
        if constexpr (KIND == kLinear) {
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < V; ++j) w[i][j] = gv[i][j];
        } else {
          T xn[R], ynl[V], acc[R][V];
#pragma unroll
          for (int i = 0; i < R; ++i) {
            xn[i] = T(0);
#pragma unroll
            for (int j = 0; j < V; ++j) acc[i][j] = T(0);
          }
#pragma unroll
          for (int j = 0; j < V; ++j) ynl[j] = yn[j];
          for (int kk = 0; kk < (D == 0 ? d : DC); kk += DC) {
            T xc[R][DC], yc[V][DC];
#pragma unroll
            for (int i = 0; i < R; ++i) load_depth<DC>(x + (size_t)rows[i] * d + kk, d - kk, xc[i]);
            if constexpr (D == 0) {
#pragma unroll
              for (int j = 0; j < V; ++j) load_depth<DC>(y + (size_t)cols[j] * d + kk, d - kk, yc[j]);
#pragma unroll
              for (int j = 0; j < V; ++j)
#pragma unroll
                for (int k = 0; k < DC; ++k) ynl[j] = fma(yc[j][k], yc[j][k], ynl[j]);
            } else {
#pragma unroll
              for (int j = 0; j < V; ++j)
#pragma unroll
                for (int k = 0; k < DC; ++k) yc[j][k] = yv[j][k];
#pragma unroll
              for (int i = 0; i < R; ++i)
#pragma unroll
                for (int k = 0; k < DC; ++k) xv[i][k] = xc[i][k];
            }
#pragma unroll
            for (int k = 0; k < DC; ++k) {
#pragma unroll
              for (int i = 0; i < R; ++i) xn[i] = fma(xc[i][k], xc[i][k], xn[i]);
#pragma unroll
              for (int i = 0; i < R; ++i)
#pragma unroll
                for (int j = 0; j < V; ++j) acc[i][j] = fma(xc[i][k], yc[j][k], acc[i][j]);
            }
          }
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < V; ++j) {
              T d2 = xn[i] + ynl[j] - T(2) * acc[i][j];
              d2 = d2 > T(0) ? d2 : T(0);
              T kv, h;
              w[i][j] = gv[i][j] * g_prime<KIND, T>(d2, alpha, hia, &kv, &h);
              if (KIND == kRq && g.want_alpha && k0 == 0) alpha_acc = fma(gv[i][j], h, alpha_acc);
            }
        }
        if (D == 0 || KIND == kLinear) {
#pragma unroll
          for (int i = 0; i < R; ++i) load_depth<DC>(x + (size_t)rows[i] * d + k0, d - k0, xv[i]);
        }

        // This pass's slice of the gradient: xbar_i += W_ij (x_i - y_j),
        // ybar_j += W_ij (y_j - x_i); linear: xbar_i += g_ij y_j, ybar_j
        // += g_ij x_i.
        T xacc[R][DC];
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int k = 0; k < DC; ++k) xacc[i][k] = T(0);
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int j = 0; j < V; ++j)
#pragma unroll
            for (int k = 0; k < DC; ++k) {
              if (KIND == kLinear) {
                xacc[i][k] = fma(w[i][j], yv[j][k], xacc[i][k]);
                yacc[j][k] = fma(w[i][j], xv[i][k], yacc[j][k]);
              } else {
                const T diff = xv[i][k] - yv[j][k];
                xacc[i][k] = fma(w[i][j], diff, xacc[i][k]);
                yacc[j][k] = fma(-w[i][j], diff, yacc[j][k]);
              }
            }

        // The warp's lanes share its rows: sum over them (a fixed xor
        // butterfly), and lane e % 32 adds entry e into the block's slice.
        if (g.want_x) {
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int k = 0; k < DC; ++k)
#pragma unroll
              for (int o = 16; o > 0; o >>= 1)
                xacc[i][k] += __shfl_xor_sync(0xffffffffu, xacc[i][k], o);
#pragma unroll
          for (int e = 0; e < R * DC; ++e) {
            const int i = e / DC, k = e % DC;
            if (lane == e % 32 && r0 + i < r_end && k0 + k < d) {
              T* p = xdst + (size_t)(r0 + i) * d + k0 + k;
              *p = (cb == c_begin ? T(0) : *p) + kScale * xacc[i][k];
            }
          }
        }
      }

      // The warps share the block's columns: sum over them in order.
      if (g.want_y) {
#pragma unroll
        for (int k = 0; k < DC; ++k) {
#pragma unroll
          for (int j = 0; j < V; ++j) ysum[warp][lane * V + j] = yacc[j][k];
          __syncthreads();
          for (int c = threadIdx.x; c < TN; c += kGramThreads) {
            T s = ysum[0][c];
#pragma unroll
            for (int w2 = 1; w2 < kGramWarps; ++w2) s += ysum[w2][c];
            if (cb + c < c_end && k0 + k < d) ydst[(size_t)(cb + c) * d + k0 + k] = kScale * s;
          }
          __syncthreads();
        }
      }
    }
  }

  if (KIND == kRq && g.want_alpha) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) alpha_acc += __shfl_xor_sync(0xffffffffu, alpha_acc, o);
    if (lane == 0) asum[warp] = alpha_acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      T s = asum[0];
#pragma unroll
      for (int w2 = 1; w2 < kGramWarps; ++w2) s += asum[w2];
      dst[(size_t)b * g.count + g.a_off + a] = s;
      if (g.fold) dst[(size_t)(g.splits + b) * g.count + g.a_off + a] = T(0);
    }
  }
}

template <int KIND, typename S>
void bwd_depth(int dt, const S* x, const S* y, const S* gbar, typename Arith<S>::T* dst,
               const BwdArgs& g, const typename Arith<S>::T* alpha, cudaStream_t s) {
  const dim3 grid(g.splits, g.splits);
  switch (dt) {
    case 1: gram_bwd_kernel<KIND, S, 1><<<grid, kGramThreads, 0, s>>>(x, y, gbar, dst, g, alpha); break;
    case 2: gram_bwd_kernel<KIND, S, 2><<<grid, kGramThreads, 0, s>>>(x, y, gbar, dst, g, alpha); break;
    case 4: gram_bwd_kernel<KIND, S, 4><<<grid, kGramThreads, 0, s>>>(x, y, gbar, dst, g, alpha); break;
    case 8: gram_bwd_kernel<KIND, S, 8><<<grid, kGramThreads, 0, s>>>(x, y, gbar, dst, g, alpha); break;
    default: gram_bwd_kernel<KIND, S, 0><<<grid, kGramThreads, 0, s>>>(x, y, gbar, dst, g, alpha); break;
  }
}

// Both launches of one call: the sweep into `out` (or into `work`, then
// the fixed-order sum of its slices into `out`, when there are several).
template <typename S>
cudaError_t bwd_launch(int kind, const void* xp, const void* yp, const void* gp, void* outp,
                       void* workp, const BwdArgs& g, const void* alpha, cudaStream_t s) {
  using T = typename Arith<S>::T;
  const S* x = static_cast<const S*>(xp);
  const S* y = static_cast<const S*>(yp);
  const S* gbar = static_cast<const S*>(gp);
  const int slices = g.fold ? 2 * g.splits : g.splits;
  T* dst = static_cast<T*>(slices > 1 ? workp : outp);
  const int dt = depth_template(g.d);
  const T* a = static_cast<const T*>(alpha);
  switch (kind) {
    case kEq: bwd_depth<kEq, S>(dt, x, y, gbar, dst, g, a, s); break;
    case kRq: bwd_depth<kRq, S>(dt, x, y, gbar, dst, g, a, s); break;
    case kMatern12: bwd_depth<kMatern12, S>(dt, x, y, gbar, dst, g, a, s); break;
    case kMatern32: bwd_depth<kMatern32, S>(dt, x, y, gbar, dst, g, a, s); break;
    case kMatern52: bwd_depth<kMatern52, S>(dt, x, y, gbar, dst, g, a, s); break;
    case kLinear: bwd_depth<kLinear, S>(dt, x, y, gbar, dst, g, a, s); break;
    default: return cudaErrorInvalidValue;
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || slices == 1) return err;
  return reduce_splits<T>(static_cast<const T*>(workp), static_cast<T*>(outp), g.count, slices, s);
}

}  // namespace
