// K1's backward kernel and its launcher, templated on the storage type:
// gram_bwd.cu instantiates float32 and bfloat16 (and holds the C entry
// point), gram_bwd_f64.cu float64, so that nvcc builds the two at once.
// See gram_bwd.cu for what it computes and how.

#pragma once

#include "gram_elem.cuh"

namespace stheno {

// One call: a sweep of spans x groups blocks (ops/gram_bwd.py:
// launch_shape), then, where partials were written, their sum. Block (a, b)
// sweeps the rows [a rows, + rows) against the columns [b span, + span), in
// tiles of 128 columns, one a warp at a time: with wcols = 1 the block's 8
// warps share each tile and take every 8th step of R rows; with wcols = 8
// warp w takes tiles w, w + 8, ... of the span and every row of the group.
// out holds the x part (nx = n d, when want_x), the y part (ny = m d, when
// want_y and not fold) and rq's d alpha (one entry, when want_alpha). A
// part is sliced when more than one block adds into an entry (x: spans >
// 1; y: groups > 1; both with fold, x is y): block (a, b) then writes its x
// partials into x slice b and its y partials into y slice a of work, each
// entry once, and gram_bwd_reduce adds the slices in a fixed order, x's
// first (with fold the y slices, of n d entries too, into the same sum).
// rq's alpha partials, one a block, sit after the slices.
struct BwdArgs {
  int n, m, d;
  int groups, rows, spans, span, wcols;
  int want_x, want_y, want_alpha, fold, vec_ok;
  int x_sliced, y_sliced;
  size_t nx, ny, y_work, a_work;
};

}  // namespace stheno

namespace {

constexpr int kBwdCols = 4;                  // columns a lane
constexpr int kBwdTile = 32 * kBwdCols;      // columns a warp's tile
constexpr int kBwdInFlight = 32;             // slice loads in flight a thread

// Rows a step of a warp: 4 at depths 1 and 2, 2 at depth 4, else 1; half
// that (at least 1) in float64, whose registers are twice the size.
template <typename T, int D>
constexpr int kBwdRows = D == 1 || D == 2 ? (sizeof(T) == 8 ? 2 : 4)
                         : D == 4       ? (sizeof(T) == 8 ? 1 : 2)
                                        : 1;

// Steps of a warp's cotangent rows in flight: copied ahead (cp.async) into
// a ring of kBwdStages steps in shared memory, which holds none of them in
// registers. Measured on the H100 at the paths' shapes: 2 stages beat the
// next step in registers (by 1.2x at 512 x 10^6 and 1.5x in float64 at
// 2000^2) and 3 or 4 stages.
constexpr int kBwdStages = 2;
template <typename S, typename T, int D>
constexpr int kBwdRingBytes = kGramWarps * kBwdStages * kBwdRows<T, D> * kBwdTile * (int)sizeof(S);

// A lane's kBwdCols columns of a tile are H chunks of VV (one 16-byte load
// of float32 or two of float64, one 8-byte load of bfloat16): chunk h at
// tile + h 32 VV + lane VV, so that a warp's load of one chunk covers
// consecutive bytes of a row.
template <typename S>
struct BwdLane {
  static constexpr int VV = kVec<S> < kBwdCols ? kVec<S> : kBwdCols, H = kBwdCols / VV;
  int col[H];           // the first column of each chunk
  bool vec[H];          // one load serves the chunk
  bool cok[kBwdCols];   // column j lies in the span
  int cl[kBwdCols];     // column j, clamped into the span (for y's loads)

  __device__ __forceinline__ BwdLane(int tile, int c_end, int lane, bool vec_ok) {
#pragma unroll
    for (int h = 0; h < H; ++h) {
      col[h] = tile + h * 32 * VV + lane * VV;
      vec[h] = vec_ok && col[h] + VV <= c_end;
#pragma unroll
      for (int u = 0; u < VV; ++u) {
        cok[h * VV + u] = col[h] + u < c_end;
        cl[h * VV + u] = min(col[h] + u, c_end - 1);
      }
    }
  }
  // The offset of column j in its tile.
  static __device__ __forceinline__ int offset(int lane, int j) {
    return (j / VV) * 32 * VV + lane * VV + j % VV;
  }
};

// What a warp's step computes with: R rows of the cotangent at the lane's
// columns (0 past the edges) and the rows' depth slice.
template <typename T, int R, int DC>
struct BwdStep {
  T gv[R][kBwdCols], xv[R][DC];
};

template <typename S, typename T, int R, int DC>
__device__ __forceinline__ void load_xrows(BwdStep<T, R, DC>& st, const S* __restrict__ x, int r0,
                                           int r_end, int d, int k0) {
#pragma unroll
  for (int i = 0; i < R; ++i)
    load_depth<DC>(x + (size_t)min(r0 + i, r_end - 1) * d + k0, d - k0, st.xv[i]);
}

// A step's R cotangent rows at the lane's columns into its slot of the
// warp's ring, laid out as the tile's columns: each lane copies the chunks
// it reads itself, so no barrier orders them. Past the edges (and where a
// row's chunk is not aligned) plain loads write the slot, 0 past the edges.
template <typename S, int R>
__device__ __forceinline__ void stage_rows(S* slot, const BwdLane<S>& L, const S* __restrict__ gbar,
                                           int lane, int r0, int r_end, int m) {
  constexpr int VV = BwdLane<S>::VV;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool ok = r0 + i < r_end;
    const S* row = gbar + (size_t)(r0 + i) * m;  // read only where ok
#pragma unroll
    for (int h = 0; h < BwdLane<S>::H; ++h) {
      S* p = slot + i * kBwdTile + h * 32 * VV + lane * VV;
      if (ok && L.vec[h]) {
        if constexpr (VV * sizeof(S) == 16) {
          cp_async16(p, row + L.col[h]);
        } else {
          cp_async8(p, row + L.col[h]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < VV; ++u)
          p[u] = ok && L.cok[h * VV + u] ? __ldg(row + L.col[h] + u) : S{};
      }
    }
  }
}

template <typename S, typename T, int R, int DC>
__device__ __forceinline__ void read_rows(BwdStep<T, R, DC>& st, const S* slot, int lane) {
  constexpr int VV = BwdLane<S>::VV;
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int h = 0; h < BwdLane<S>::H; ++h) {
      const S* p = slot + i * kBwdTile + h * 32 * VV + lane * VV;
      S t[VV];
      if constexpr (VV * sizeof(S) == 16) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        memcpy(t, &u, 16);
      } else {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        memcpy(t, &u, 8);
      }
#pragma unroll
      for (int u = 0; u < VV; ++u) st.gv[i][h * VV + u] = to_arith(t[u]);
    }
}

// s plus p[0], p[stride], ..., p[(count - 1) stride] in that order, read
// through L2 (other blocks wrote them): up to kBwdInFlight loads go out
// before the first add.
template <typename T>
__device__ __forceinline__ T add_slices(T s, const T* p, size_t stride, int count) {
  for (int k = 0; k < count; k += kBwdInFlight) {
    T v[kBwdInFlight];
#pragma unroll
    for (int u = 0; u < kBwdInFlight; ++u)
      v[u] = k + u < count ? __ldcg(p + (size_t)(k + u) * stride) : T(0);
#pragma unroll
    for (int u = 0; u < kBwdInFlight; ++u)
      if (k + u < count) s += v[u];
  }
  return s;
}

// g'(d2), with K and rq's h, as gram_kind.cuh's g_prime, but in float32
// with the special-function unit's exp and reciprocal (__expf, __fdividef:
// within 2 ulp, where libdevice's take several instructions more; rq's log
// stays libdevice's): 10% off rq's and Matern-1/2's time at 2000^2
// (PERF.md). float64 takes g_prime.
template <int KIND, typename T>
__device__ __forceinline__ T bwd_g_prime(T d2, T alpha, T hia, T* k, T* h) {
  if constexpr (sizeof(T) == 4 && KIND != kLinear) {
    if constexpr (KIND == kEq) {
      *k = __expf(T(-0.5) * d2);
      return T(-0.5) * *k;
    }
    if constexpr (KIND == kRq) {
      const T base = T(1) + d2 * hia;
      const T lb = dev_log(base);
      *k = __expf(-alpha * lb);
      const T ib = __fdividef(T(1), base);
      *h = *k * (d2 * hia * ib - lb);
      return T(-0.5) * *k * ib;
    }
    const T d = dev_sqrt(d2 + T(1e-36));
    if constexpr (KIND == kMatern12) {
      *k = __expf(-d);
      return __fdividef(T(-0.5) * *k, d);
    }
    if constexpr (KIND == kMatern32) {
      const T r = T(1.7320508075688772) * d;
      const T e = __expf(-r);
      *k = (T(1) + r) * e;
      return T(-1.5) * e;
    }
    const T r = T(2.23606797749979) * d;  // matern52
    const T e = __expf(-r);
    *k = (T(1) + r + r * r / T(3)) * e;
    return T(-5.0 / 6.0) * (T(1) + r) * e;
  }
  return g_prime<KIND, T>(d2, alpha, hia, k, h);
}

// rq's d alpha into *dst: the blocks' count partials, each thread a run of
// them in order, then the runs' sums over warp 0's lanes (8 each in order,
// then a fixed tree). Called by every thread of one block.
template <typename T>
__device__ __forceinline__ void add_alpha_partials(const T* part, int count, T* dst, T* red) {
  const int per = (count + kGramThreads - 1) / kGramThreads;
  const int lo = min(count, (int)threadIdx.x * per), hi = min(count, lo + per);
  T s = T(0);
  for (int i = lo; i < hi; ++i) s += __ldcg(part + i);
  __syncthreads();
  red[threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    T v = red[lane * 8];
#pragma unroll
    for (int i = 1; i < 8; ++i) v += red[lane * 8 + i];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) *dst = v;
  }
}

template <int KIND, typename S, int D>
__global__ void __launch_bounds__(kGramThreads, 2)
gram_bwd_kernel(const S* __restrict__ x, const S* __restrict__ y, const S* __restrict__ gbar,
                typename Arith<S>::T* __restrict__ out, typename Arith<S>::T* __restrict__ work,
                BwdArgs g, const typename Arith<S>::T* __restrict__ alpha_p) {
  using T = typename Arith<S>::T;
  constexpr int C = kBwdCols, R = kBwdRows<T, D>, DC = D == 0 ? 8 : D, P = R * DC;
  constexpr T kScale = KIND == kLinear ? T(1) : T(2);
  static_assert(P <= 32 && (P & (P - 1)) == 0, "one lane writes each row's sum");
  extern __shared__ __align__(16) unsigned char bwd_smem[];
  __shared__ T red[kGramWarps];

  pdl_launch_dependents();  // the sum's blocks may start: they wait for this grid's end
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a = blockIdx.y, b = blockIdx.x;
  const int n = g.n, m = g.m, d = g.d, wcols = g.wcols, wrows = kGramWarps / wcols;
  const int wc = warp % wcols, wr = warp / wcols;
  const int r_begin = a * g.rows, r_end = min(n, r_begin + g.rows);
  const int c_begin = b * g.span, c_end = min(m, c_begin + g.span);
  const int rounds = g.span / (kBwdTile * wcols), stride = wrows * R;
  const int depth = D == 0 ? d : D;
  const T alpha = KIND == kRq ? __ldg(alpha_p) : T(1);  // rq's alpha, read once
  const T hia = T(0.5) / alpha;
  const bool want_a = KIND == kRq && g.want_alpha;

  // Shared memory: the warps' rings of cotangent rows, then their partials
  // staged: x's when a warp's rows meet several tiles (wcols x rows x DC),
  // y's when several warps share a tile (wrows x kBwdTile x DC).
  const bool x_staged = g.want_x && (wcols > 1 || rounds > 1);
  const bool y_staged = g.want_y && wrows > 1;
  constexpr int ST = kBwdStages, SE = R * kBwdTile;  // a warp's stages, a stage's entries
  S* ring = reinterpret_cast<S*>(bwd_smem) + (size_t)warp * ST * SE;
  T* xs = reinterpret_cast<T*>(bwd_smem + kBwdRingBytes<S, T, D>);
  T* ys = xs + (x_staged ? (size_t)wcols * g.rows * DC : 0);
  T* xdst = g.x_sliced ? work + (size_t)b * n * d : out;
  T* ydst = g.y_sliced ? work + g.y_work + (size_t)a * m * d : out + g.nx;
  T alpha_acc = T(0);

  for (int k0 = 0; k0 < depth; k0 += DC) {  // the gradient's depth passes
    if (x_staged) {
      for (int e = threadIdx.x; e < wcols * g.rows * DC; e += kGramThreads) xs[e] = T(0);
      __syncthreads();
    }
    for (int u = 0; u < rounds; ++u) {
      const int tile = c_begin + (u * wcols + wc) * kBwdTile;
      T yacc[C][DC];
#pragma unroll
      for (int j = 0; j < C; ++j)
#pragma unroll
        for (int k = 0; k < DC; ++k) yacc[j][k] = T(0);

      if (tile < c_end) {
        const BwdLane<S> L(tile, c_end, lane, g.vec_ok);
        const int r_first = r_begin + wr * R;
        const int steps = r_first < r_end ? (r_end - r_first + stride - 1) / stride : 0;
        // The first steps' loads go out before the columns'.
        BwdStep<T, R, DC> cur, nxt;
#pragma unroll
        for (int s = 0; s < ST - 1; ++s) {
          if (s < steps)
            stage_rows<S, R>(ring + s * SE, L, gbar, lane, r_first + s * stride, r_end, m);
          cp_async_commit();
        }
        if (steps > 0) load_xrows(cur, x, r_first, r_end, d, k0);
        // The lane's columns: their depth slice, and for D > 0 their norms
        // by the forward's FMA chain.
        T yv[C][DC], yn[C];
#pragma unroll
        for (int j = 0; j < C; ++j) {
          load_depth<DC>(y + (size_t)L.cl[j] * d + k0, d - k0, yv[j]);
          yn[j] = T(0);
          if constexpr (D > 0) {
#pragma unroll
            for (int k = 0; k < DC; ++k) yn[j] = fma(yv[j][k], yv[j][k], yn[j]);
          }
        }

        for (int st = 0; st < steps; ++st) {
          const int r0 = r_first + st * stride;
          // The next steps' loads go out before this step's arithmetic.
          if (st + ST - 1 < steps)
            stage_rows<S, R>(ring + ((st + ST - 1) % ST) * SE, L, gbar, lane,
                             r0 + (ST - 1) * stride, r_end, m);
          cp_async_commit();
          if (st + 1 < steps) load_xrows(nxt, x, r0 + stride, r_end, d, k0);
          cp_async_wait<ST - 1>();  // this step's copies are in
          read_rows(cur, ring + (st % ST) * SE, lane);

          // Each entry's W = gbar g'(d2), d2 by the forward's FMA chain
          // (gram.cu); linear: W = gbar.
          T w[R][C];
          if constexpr (KIND == kLinear) {
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
              for (int j = 0; j < C; ++j) w[i][j] = cur.gv[i][j];
          } else {
            T xn[R], ynl[C], acc[R][C];
#pragma unroll
            for (int i = 0; i < R; ++i) {
              xn[i] = T(0);
#pragma unroll
              for (int j = 0; j < C; ++j) acc[i][j] = T(0);
            }
#pragma unroll
            for (int j = 0; j < C; ++j) ynl[j] = yn[j];
            if constexpr (D > 0) {
#pragma unroll
              for (int k = 0; k < DC; ++k) {
#pragma unroll
                for (int i = 0; i < R; ++i) xn[i] = fma(cur.xv[i][k], cur.xv[i][k], xn[i]);
#pragma unroll
                for (int i = 0; i < R; ++i)
#pragma unroll
                  for (int j = 0; j < C; ++j) acc[i][j] = fma(cur.xv[i][k], yv[j][k], acc[i][j]);
              }
            } else {
              // The whole depth from memory, in passes of 8.
              for (int kk = 0; kk < d; kk += DC) {
                T xc[R][DC], yc[C][DC];
#pragma unroll
                for (int i = 0; i < R; ++i)
                  load_depth<DC>(x + (size_t)min(r0 + i, r_end - 1) * d + kk, d - kk, xc[i]);
#pragma unroll
                for (int j = 0; j < C; ++j)
                  load_depth<DC>(y + (size_t)L.cl[j] * d + kk, d - kk, yc[j]);
#pragma unroll
                for (int k = 0; k < DC; ++k) {
#pragma unroll
                  for (int i = 0; i < R; ++i) xn[i] = fma(xc[i][k], xc[i][k], xn[i]);
#pragma unroll
                  for (int j = 0; j < C; ++j) ynl[j] = fma(yc[j][k], yc[j][k], ynl[j]);
#pragma unroll
                  for (int i = 0; i < R; ++i)
#pragma unroll
                    for (int j = 0; j < C; ++j) acc[i][j] = fma(xc[i][k], yc[j][k], acc[i][j]);
                }
              }
            }
#pragma unroll
            for (int i = 0; i < R; ++i)
#pragma unroll
              for (int j = 0; j < C; ++j) {
                T d2 = xn[i] + ynl[j] - T(2) * acc[i][j];
                d2 = d2 > T(0) ? d2 : T(0);
                T kv, h;
                w[i][j] = cur.gv[i][j] * bwd_g_prime<KIND, T>(d2, alpha, hia, &kv, &h);
                if (want_a && k0 == 0) alpha_acc = fma(cur.gv[i][j], h, alpha_acc);
              }
          }

          // This pass's slice of the gradient: xbar_i += W_ij (x_i - y_j),
          // ybar_j += W_ij (y_j - x_i); linear: xbar_i += g_ij y_j, ybar_j
          // += g_ij x_i. Past the edges W is 0 and adds 0.
          T xacc[P];
#pragma unroll
          for (int e = 0; e < P; ++e) xacc[e] = T(0);
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < C; ++j)
#pragma unroll
              for (int k = 0; k < DC; ++k) {
                if (KIND == kLinear) {
                  xacc[i * DC + k] = fma(w[i][j], yv[j][k], xacc[i * DC + k]);
                  yacc[j][k] = fma(w[i][j], cur.xv[i][k], yacc[j][k]);
                } else {
                  const T diff = cur.xv[i][k] - yv[j][k];
                  xacc[i * DC + k] = fma(w[i][j], diff, xacc[i * DC + k]);
                  yacc[j][k] = fma(-w[i][j], diff, yacc[j][k]);
                }
              }

          // The warp's lanes share its rows: sum over them (a fixed tree);
          // one lane holds each (row, depth) entry and writes it once, or
          // adds it into the warp's staged rows.
          if (g.want_x) {
            const T sx = halving_sum<P>(xacc, lane);
            const int e = halving_entry<P>(lane), row = r0 + e / DC, k = e % DC;
            if ((lane & (32 / P - 1)) == 0 && row < r_end && k0 + k < d) {
              if (x_staged) {
                xs[((size_t)wc * g.rows + row - r_begin) * DC + k] += sx;
              } else {
                xdst[(size_t)row * d + k0 + k] = kScale * sx;
              }
            }
          }
          cur = nxt;
        }
      }

      // The tile's y partials: complete where the warp took every row of
      // the group, written once; else summed over the warps in order.
      if (g.want_y) {
        if (y_staged) {
#pragma unroll
          for (int j = 0; j < C; ++j)
#pragma unroll
            for (int k = 0; k < DC; ++k)
              ys[((size_t)wr * kBwdTile + BwdLane<S>::offset(lane, j)) * DC + k] = yacc[j][k];
          __syncthreads();
          for (int e = threadIdx.x; e < kBwdTile * DC; e += kGramThreads) {
            T sy = ys[e];
            for (int w2 = 1; w2 < wrows; ++w2) sy += ys[(size_t)w2 * kBwdTile * DC + e];
            const int col = tile + e / DC, k = k0 + e % DC;
            if (col < c_end && k < d) ydst[(size_t)col * d + k] = kScale * sy;
          }
          __syncthreads();
        } else if (tile < c_end) {
#pragma unroll
          for (int j = 0; j < C; ++j) {
            const int col = tile + BwdLane<S>::offset(lane, j);
#pragma unroll
            for (int k = 0; k < DC; ++k)
              if (col < c_end && k0 + k < d) ydst[(size_t)col * d + k0 + k] = kScale * yacc[j][k];
          }
        }
      }
    }

    // The staged x partials: summed over the warps in order, written once.
    if (x_staged) {
      __syncthreads();
      for (int e = threadIdx.x; e < g.rows * DC; e += kGramThreads) {
        T sx = xs[e];
        for (int w2 = 1; w2 < wcols; ++w2) sx += xs[(size_t)w2 * g.rows * DC + e];
        const int row = r_begin + e / DC, k = k0 + e % DC;
        if (row < r_end && k < d) xdst[(size_t)row * d + k] = kScale * sx;
      }
      __syncthreads();
    }
  }

  // rq's alpha partial of the block: over the lanes, then the warps, in order.
  if (want_a) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) alpha_acc += __shfl_xor_sync(0xffffffffu, alpha_acc, o);
    if (lane == 0) red[warp] = alpha_acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      T s = red[0];
#pragma unroll
      for (int w2 = 1; w2 < kGramWarps; ++w2) s += red[w2];
      work[g.a_work + (size_t)a * g.spans + b] = s;
    }
  }

}

// The sum of a call's partials, a second launch that may start while the
// sweep runs (programmatic dependent launch) and waits for its end: out's x
// part from the x slices (with fold, then the y slices), its y part from
// the y slices, and rq's d alpha from the blocks' partials.
template <typename T>
__global__ void __launch_bounds__(kGramThreads)
gram_bwd_reduce(const T* __restrict__ work, T* __restrict__ out, BwdArgs g, int want_a) {
  __shared__ T red[kGramThreads];
  pdl_wait();
  const size_t xs_n = (size_t)g.n * g.d, ys_n = (size_t)g.m * g.d;
  const size_t nx = g.x_sliced ? xs_n : 0, ny = g.y_sliced && !g.fold ? ys_n : 0;
  const T* yw = work + g.y_work;
  for (size_t e = (size_t)blockIdx.x * kGramThreads + threadIdx.x; e < nx + ny;
       e += (size_t)gridDim.x * kGramThreads) {
    if (e < nx) {
      // With fold the y slices (n d entries each) follow the x slices.
      const int slices = g.fold ? g.spans + g.groups : g.spans;
      out[e] = add_slices(__ldcg(work + e), work + xs_n + e, xs_n, slices - 1);
    } else {
      const size_t f = e - nx;
      out[g.nx + f] = add_slices(__ldcg(yw + f), yw + ys_n + f, ys_n, g.groups - 1);
    }
  }
  if (want_a && blockIdx.x == 0)
    add_alpha_partials(work + g.a_work, g.groups * g.spans, out + g.nx + g.ny, red);
}

// Shared memory of a launch beside the rings: the staged x and y partials.
template <typename T>
size_t bwd_stage_bytes(const BwdArgs& g, int dc) {
  const int wrows = kGramWarps / g.wcols, rounds = g.span / (kBwdTile * g.wcols);
  const bool x_staged = g.want_x && (g.wcols > 1 || rounds > 1);
  const bool y_staged = g.want_y && wrows > 1;
  return ((x_staged ? (size_t)g.wcols * g.rows * dc : 0) +
          (y_staged ? (size_t)wrows * kBwdTile * dc : 0)) * sizeof(T);
}

template <int KIND, typename S, int D>
cudaError_t bwd_launch_one(const S* x, const S* y, const S* gbar, typename Arith<S>::T* out,
                           typename Arith<S>::T* work, const BwdArgs& g,
                           const typename Arith<S>::T* alpha, cudaStream_t s) {
  using T = typename Arith<S>::T;
  const size_t bytes = kBwdRingBytes<S, T, D> + bwd_stage_bytes<T>(g, D == 0 ? 8 : D);
  auto kernel = gram_bwd_kernel<KIND, S, D>;
  if (bytes > 40 * 1024) {  // with the static shared memory, past the default 48 KB
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(g.spans, g.groups), kGramThreads, bytes, s>>>(x, y, gbar, out, work, g, alpha);
  cudaError_t err = cudaGetLastError();
  const int want_a = KIND == kRq && g.want_alpha;
  if (err != cudaSuccess || !(g.x_sliced || g.y_sliced || want_a)) return err;
  const size_t count = (g.x_sliced ? (size_t)g.n * g.d : 0) +
                       (g.y_sliced && !g.fold ? (size_t)g.m * g.d : 0);
  const size_t want = (count + kGramThreads - 1) / kGramThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(want < 1 ? 1 : want > 4096 ? 4096 : (unsigned)want);
  cfg.blockDim = dim3(kGramThreads);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, gram_bwd_reduce<T>, (const T*)work, out, g, want_a);
}

template <int KIND, typename S>
cudaError_t bwd_depth(int dt, const S* x, const S* y, const S* gbar, typename Arith<S>::T* out,
                      typename Arith<S>::T* work, const BwdArgs& g,
                      const typename Arith<S>::T* alpha, cudaStream_t s) {
  switch (dt) {
    case 1: return bwd_launch_one<KIND, S, 1>(x, y, gbar, out, work, g, alpha, s);
    case 2: return bwd_launch_one<KIND, S, 2>(x, y, gbar, out, work, g, alpha, s);
    case 4: return bwd_launch_one<KIND, S, 4>(x, y, gbar, out, work, g, alpha, s);
    case 8: return bwd_launch_one<KIND, S, 8>(x, y, gbar, out, work, g, alpha, s);
    default: return bwd_launch_one<KIND, S, 0>(x, y, gbar, out, work, g, alpha, s);
  }
}

// The launches of a call: the sweep, then the sum of its partials.
template <typename S>
cudaError_t bwd_launch(int kind, const void* xp, const void* yp, const void* gp, void* outp,
                       void* workp, const BwdArgs& g, const void* alpha, cudaStream_t s) {
  using T = typename Arith<S>::T;
  const S* x = static_cast<const S*>(xp);
  const S* y = static_cast<const S*>(yp);
  const S* gbar = static_cast<const S*>(gp);
  T* out = static_cast<T*>(outp);
  T* work = static_cast<T*>(workp);
  const T* a = static_cast<const T*>(alpha);
  const int dt = depth_template(g.d);
  switch (kind) {
    case kEq: return bwd_depth<kEq, S>(dt, x, y, gbar, out, work, g, a, s);
    case kRq: return bwd_depth<kRq, S>(dt, x, y, gbar, out, work, g, a, s);
    case kMatern12: return bwd_depth<kMatern12, S>(dt, x, y, gbar, out, work, g, a, s);
    case kMatern32: return bwd_depth<kMatern32, S>(dt, x, y, gbar, out, work, g, a, s);
    case kMatern52: return bwd_depth<kMatern52, S>(dt, x, y, gbar, out, work, g, a, s);
    case kLinear: return bwd_depth<kLinear, S>(dt, x, y, gbar, out, work, g, a, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
