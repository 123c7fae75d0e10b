// The forward rule of K1's backward: its kernel and launcher, templated on
// the arithmetic type. gram_bwd_jvp.cu instantiates float32 (and holds the
// C entry point), gram_bwd_jvp_f64.cu float64, so that nvcc builds the two
// at once. See gram_bwd_jvp.cu for what it computes and how.

#pragma once

#include "gram_elem.cuh"
#include "gram_matvec.cuh"  // reduce_splits

namespace stheno {

// One call. The grid is spans x splits blocks: block (a, b) sweeps the
// rows [a rows, + rows) against the columns [b 128, + 128), 4 a lane.
// `work` holds the x slices (spans of them, nx = batch n d entries each,
// when want_x), then the y slices: splits of them, each of
// nx entries with fold (x is y: both roles into one sum) or of ny = batch
// m d without. Block (a, b) writes its rows' x partials into x slice b and
// its columns' y partials into y slice a, each entry once; rq's alpha
// partials go straight to out (batch x splits x spans, after the x and y
// parts).
struct JvbArgs {
  int n, m, d, rows, splits, spans, batch;
  int want_x, want_y, want_alpha, fold, vec_ok;
  size_t nx, ny;
};

cudaError_t gram_bwd_jvp_f64(int kind, const void* x, const void* y, const void* gbar,
                             const void* gt, const void* xt, const void* yt, const void* alpha,
                             const void* at, void* out, void* work, const JvbArgs& g,
                             cudaStream_t s);

}  // namespace stheno

namespace {

constexpr int kJvbGroup = 8;  // directions in one sweep at depth 1
constexpr int kJvbDeep = 8;   // depth held in registers at depth > 1 (one direction a sweep)
constexpr int kJvbCols = 4;   // columns a lane: 16 bytes of float32, 32 of float64
constexpr int kJvbSpan = 32 * kJvbCols;  // a block's columns

// How a warp's step reaches its registers, as measured on the H100 at the
// flagship's shapes: float32 tiles are loaded into registers a step ahead
// of their use; float64 tiles, twice the bytes an entry, are copied into a
// ring of shared memory (cp.async), S steps in flight, which holds none of
// them in registers (float64 through registers spilled and ran 1.4x
// slower; float32 through the ring ran no faster).
template <typename T>
constexpr bool kJvbStaged = sizeof(T) == 8;
// Rows a step of a warp, within the registers that allow two blocks an SM
// where the path launches.
template <typename T, int NB, int D>
constexpr int kJvbRows = D == 1 && NB == 1 && sizeof(T) == 4 ? 2 : 1;
template <typename T, int NB, int D>
constexpr int kJvbMinBlocks = D == 1 && NB <= 4 ? 2 : 1;
// A step's tiles for the block's warps in the ring, and its stages: as many
// as fit in 64 KB, 2 to 4.
template <typename T, int NB, int D>
constexpr int kJvbStageBytes =
    kGramWarps * kJvbRows<T, NB, D> * (1 + NB) * 32 * kJvbCols * (int)sizeof(T);
template <typename T, int NB, int D>
constexpr int kJvbStages = 65536 / kJvbStageBytes<T, NB, D> >= 4   ? 4
                           : 65536 / kJvbStageBytes<T, NB, D> >= 3 ? 3
                                                                   : 2;
template <typename T, int NB, int D>
constexpr int kJvbRingBytes =
    kJvbStaged<T> ? kJvbStages<T, NB, D> * kJvbStageBytes<T, NB, D> : 0;

// Column j of a lane: its kJvbCols columns are kJvbCols / V vectors of V
// (16 bytes), vector h at c_begin + h 32 V + lane V, so that each 16-byte
// load of a warp covers 512 consecutive bytes of a row.
template <typename T>
__device__ __forceinline__ int lane_col(int c_begin, int lane, int j) {
  constexpr int V = kVec<T>;
  return c_begin + (j / V) * 32 * V + lane * V + j % V;
}

// What a lane's loads need that does not change from step to step.
template <typename T, int NB>
struct JvbLane {
  static constexpr int V = kVec<T>, H = kJvbCols / kVec<T>;
  const T* tile[1 + NB];  // gbar, then each direction's tangent tile (null: absent, reads 0)
  const T* xtile[NB];     // each direction's tangent of x (null: absent)
  int col[H];             // the first column of each vector
  bool vec[H];            // a 16-byte load serves the vector
  bool cok[kJvbCols];     // column j lies in the span

  __device__ __forceinline__ JvbLane(const T* gbar, const T* gt, const T* xt, int n, int m,
                                     int d, int q0, int nb, int c_begin, int c_end, int lane,
                                     bool vec_ok) {
    tile[0] = gbar;
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      tile[1 + q] = gt != nullptr && q < nb ? gt + (size_t)(q0 + q) * n * m : nullptr;
      xtile[q] = xt != nullptr && q < nb ? xt + (size_t)(q0 + q) * n * d : nullptr;
    }
#pragma unroll
    for (int h = 0; h < H; ++h) {
      col[h] = lane_col<T>(c_begin, lane, h * V);
      vec[h] = vec_ok && col[h] + V <= c_end;
#pragma unroll
      for (int u = 0; u < V; ++u) cok[h * V + u] = col[h] + u < c_end;
    }
  }
};

// What a warp's step reads: R rows of gbar and of the nb tangent tiles at
// the lane's columns (0 past the edges and for absent tiles), and the
// rows' depth slice and tangents.
template <typename T, int R, int NB, int D>
struct JvbStep {
  T gv[R][kJvbCols], gtv[R][NB][kJvbCols], xv[R][D], xtv[R][NB][D];
};

template <typename T, int R, int NB, int D>
__device__ __forceinline__ void load_rows(JvbStep<T, R, NB, D>& st, const JvbLane<T, NB>& L,
                                          const T* __restrict__ x, int r0, int r_end, int d,
                                          int k0) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const size_t ro = (size_t)min(r0 + i, r_end - 1) * d + k0;
    load_depth<D>(x + ro, d - k0, st.xv[i]);
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      if (L.xtile[q] != nullptr) {
        load_depth<D>(L.xtile[q] + ro, d - k0, st.xtv[i][q]);
      } else {
#pragma unroll
        for (int k = 0; k < D; ++k) st.xtv[i][q][k] = T(0);
      }
    }
  }
}

// The lane's kJvbCols columns of a tile's row into registers, 0 past the
// edges: 16-byte loads where the row keeps them aligned.
template <typename T, int NB>
__device__ __forceinline__ void load_cols(const T* row, bool ok, const JvbLane<T, NB>& L,
                                          T (&v)[kJvbCols]) {
  constexpr int V = kVec<T>;
#pragma unroll
  for (int h = 0; h < kJvbCols / V; ++h) {
    if (ok && L.vec[h]) {
      load16(row + L.col[h], v + h * V);
    } else {
#pragma unroll
      for (int u = 0; u < V; ++u)
        v[h * V + u] = ok && L.cok[h * V + u] ? __ldg(row + L.col[h] + u) : T(0);
    }
  }
}

template <typename T, int R, int NB, int D>
__device__ __forceinline__ void load_tiles(JvbStep<T, R, NB, D>& st, const JvbLane<T, NB>& L,
                                           int r0, int r_end, int m) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool ok = r0 + i < r_end;
    const size_t ro = (size_t)(r0 + i) * m;  // read only where ok
    load_cols(L.tile[0] + ro, ok, L, st.gv[i]);
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      if (L.tile[1 + q] != nullptr) {
        load_cols(L.tile[1 + q] + ro, ok, L, st.gtv[i][q]);
      } else {
#pragma unroll
        for (int j = 0; j < kJvbCols; ++j) st.gtv[i][q][j] = T(0);
      }
    }
  }
}

// Tile t of a step's row i in a warp's stage: t = 0 is gbar, 1 + q the
// tangent tile of direction q; the lane's vector h of it at (h 32 + lane)
// V, so that each 16-byte copy and read of a warp covers 512 bytes.
template <int NB, typename P>
__device__ __forceinline__ P* stage_tile(P* stage, int i, int t) {
  return stage + (i * (1 + NB) + t) * 32 * kJvbCols;
}

// A warp's step into its stage: each lane copies the bytes it will read
// itself, so no barrier orders them; 16-byte copies where the row keeps
// them aligned, otherwise (and past the edges) plain loads, 0 past the
// edges. Absent tangent tiles are not staged: they read as 0.
template <typename T, int R, int NB>
__device__ __forceinline__ void stage_step(T* stage, const JvbLane<T, NB>& L, int lane, int r0,
                                           int r_end, int m) {
  constexpr int V = kVec<T>;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const bool ok = r0 + i < r_end;
    const size_t ro = (size_t)(r0 + i) * m;  // read only where ok
#pragma unroll
    for (int t = 0; t < 1 + NB; ++t) {
      if (L.tile[t] == nullptr) continue;
      const T* src = L.tile[t] + ro;
      T* dst = stage_tile<NB>(stage, i, t);
#pragma unroll
      for (int h = 0; h < kJvbCols / V; ++h) {
        T* p = dst + (h * 32 + lane) * V;
        if (ok && L.vec[h]) {
          cp_async16(p, src + L.col[h]);
        } else {
#pragma unroll
          for (int u = 0; u < V; ++u)
            p[u] = ok && L.cok[h * V + u] ? __ldg(src + L.col[h] + u) : T(0);
        }
      }
    }
  }
}

// The lane's kJvbCols columns of tile t of row i, from the warp's stage.
template <typename T, int NB>
__device__ __forceinline__ void read_tile(const T* stage, int i, int t, int lane,
                                          T (&v)[kJvbCols]) {
  constexpr int V = kVec<T>;
  const T* src = stage_tile<NB>(stage, i, t);
#pragma unroll
  for (int h = 0; h < kJvbCols / V; ++h) {
    const uint4 u = *reinterpret_cast<const uint4*>(src + (h * 32 + lane) * V);
    memcpy(v + h * V, &u, 16);
  }
}

template <typename T, int R, int NB, int D>
__device__ __forceinline__ void read_step(JvbStep<T, R, NB, D>& st, const T* stage,
                                          const JvbLane<T, NB>& L, int lane) {
#pragma unroll
  for (int i = 0; i < R; ++i) {
    read_tile<T, NB>(stage, i, 0, lane, st.gv[i]);
#pragma unroll
    for (int q = 0; q < NB; ++q) {
      if (L.tile[1 + q] != nullptr) {
        read_tile<T, NB>(stage, i, 1 + q, lane, st.gtv[i][q]);
      } else {
#pragma unroll
        for (int j = 0; j < kJvbCols; ++j) st.gtv[i][q][j] = T(0);
      }
    }
  }
}

// One sweep: directions [q0, q0 + nb) (nb <= NB) and the depth slice [k0,
// k0 + D) of the partials. At depth d <= D the whole depth is in registers;
// deeper (D = kJvbDeep, one sweep per slice) the inner products run over
// the whole depth from memory.
template <int KIND, typename T, int NB, int D>
__global__ void __launch_bounds__(kGramThreads, (kJvbMinBlocks<T, NB, D>))
gram_bwd_jvp_kernel(const T* __restrict__ x, const T* __restrict__ y, const T* __restrict__ gbar,
                    const T* __restrict__ gt, const T* __restrict__ xt,
                    const T* __restrict__ yt, const T* __restrict__ alpha_p,
                    const T* __restrict__ at, T* __restrict__ xw, T* __restrict__ yw,
                    size_t ystride, T* __restrict__ aw, JvbArgs g, int q0, int nb, int k0) {
  constexpr int VC = kJvbCols, TN = kJvbSpan, R = kJvbRows<T, NB, D>, TM = kGramWarps * R;
  constexpr int P = R * NB * D, P2 = next_pow2(P);
  constexpr T kScale = KIND == kLinear ? T(1) : T(2);
  static_assert(P2 <= 32, "one lane writes each row's sum");
  // The columns' tangents of this slice, lane-major: [q][k][j][lane] is
  // the lane's column j, so a warp reads 32 consecutive words.
  __shared__ T yts[NB][D][VC][32];
  __shared__ T red[kGramWarps][TN];
  __shared__ T ared[kGramWarps][NB];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int a = blockIdx.y, b = blockIdx.x;
  const int n = g.n, m = g.m, d = g.d;
  const int r_begin = a * g.rows, r_end = min(n, r_begin + g.rows);
  const int c_begin = b * TN, c_end = min(m, c_begin + TN);
  const bool whole = D == 1 || d <= D;
  const bool want_a = KIND == kRq && g.want_alpha && k0 == 0;
  const T alpha = KIND == kRq ? __ldg(alpha_p) : T(1);  // rq's alpha, read once
  const T hia = T(0.5) / alpha;
  const JvbLane<T, NB> L(gbar, gt, xt, n, m, d, q0, nb, c_begin, c_end, lane, g.vec_ok);

  // The first step's loads (float64: the first S - 1 steps' copies into
  // the warp's ring of S stages) go out before anything else.
  constexpr int S = kJvbStages<T, NB, D>, SE = R * (1 + NB) * 32 * VC;
  extern __shared__ __align__(16) unsigned char jvb_ring[];
  T* ring = reinterpret_cast<T*>(jvb_ring) + (size_t)warp * S * SE;
  const int steps = r_begin < r_end ? (r_end - r_begin + TM - 1) / TM : 0;
  JvbStep<T, R, NB, D> cur, nxt;
  if (steps > 0) {
    load_rows(cur, L, x, r_begin + warp * R, r_end, d, k0);
    if constexpr (!kJvbStaged<T>) load_tiles(cur, L, r_begin + warp * R, r_end, m);
  }
  if constexpr (kJvbStaged<T>) {
#pragma unroll
    for (int st = 0; st < S - 1; ++st) {
      if (st < steps) stage_step<T, R, NB>(ring + st * SE, L, lane, r_begin + st * TM + warp * R,
                                           r_end, m);
      cp_async_commit();
    }
  }

  for (int e = threadIdx.x; e < NB * D * TN; e += kGramThreads) {
    const int l = e % 32, j = (e / 32) % VC, k = (e / TN) % D, q = e / (TN * D);
    const int col = lane_col<T>(c_begin, l, j);
    yts[q][k][j][l] = yt != nullptr && q < nb && col < c_end && k0 + k < d
                          ? __ldg(yt + ((size_t)(q0 + q) * m + col) * d + k0 + k)
                          : T(0);
  }

  // The lane's columns: their slice in registers, their norms over the
  // whole depth (K1's FMA chain).
  int cols[VC];
  T yv[VC][D], yn[VC];
#pragma unroll
  for (int j = 0; j < VC; ++j) {
    cols[j] = min(lane_col<T>(c_begin, lane, j), c_end - 1);
    load_depth<D>(y + (size_t)cols[j] * d + k0, d - k0, yv[j]);
    yn[j] = T(0);
    if (KIND != kLinear) {
      if (whole) {
#pragma unroll
        for (int k = 0; k < D; ++k) yn[j] = fma(yv[j][k], yv[j][k], yn[j]);
      } else {
        for (int k = 0; k < d; ++k) {
          const T v = __ldg(y + (size_t)cols[j] * d + k);
          yn[j] = fma(v, v, yn[j]);
        }
      }
    }
  }
  T atv[NB];
#pragma unroll
  for (int q = 0; q < NB; ++q)
    atv[q] = KIND == kRq && at != nullptr && q < nb ? __ldg(at + q0 + q) : T(0);

  // The lane's entry of the rows' x sums, and where it goes: the same at
  // every step but for the rows.
  const int e = halving_entry<P2>(lane);
  const int ei = e / (NB * D), eq = (e / D) % NB, ek = e % D;
  const bool writer =
      g.want_x && (lane & (32 / P2 - 1)) == 0 && e < P && eq < nb && k0 + ek < d;
  T* xdst = xw + (size_t)b * g.nx + ((size_t)(q0 + eq) * n + r_begin + warp * R + ei) * d + k0 + ek;
  __syncthreads();

  T yacc[VC][NB][D], aacc[NB];
#pragma unroll
  for (int q = 0; q < NB; ++q) {
    aacc[q] = T(0);
#pragma unroll
    for (int j = 0; j < VC; ++j)
#pragma unroll
      for (int k = 0; k < D; ++k) yacc[j][q][k] = T(0);
  }

  for (int st = 0; st < steps; ++st, xdst += (size_t)TM * d) {
    const int r0 = r_begin + st * TM + warp * R;
    // The next step's loads (float64: step st + S - 1's copies) go out
    // before this step's arithmetic.
    if (st + 1 < steps) {
      load_rows(nxt, L, x, r0 + TM, r_end, d, k0);
      if constexpr (!kJvbStaged<T>) load_tiles(nxt, L, r0 + TM, r_end, m);
    }
    if constexpr (kJvbStaged<T>) {
      if (st + S - 1 < steps)
        stage_step<T, R, NB>(ring + ((st + S - 1) % S) * SE, L, lane, r0 + (S - 1) * TM, r_end,
                             m);
      cp_async_commit();
      // This step's copies are in (each lane reads only what it copied).
      cp_async_wait<S - 1>();
      read_step(cur, ring + (st % S) * SE, L, lane);
    }

    T xacc[P2];
#pragma unroll
    for (int i = 0; i < P2; ++i) xacc[i] = T(0);

#pragma unroll
    for (int i = 0; i < R; ++i) {
      const bool rok = r0 + i < r_end;
      const int row = min(r0 + i, r_end - 1);
      T xn = T(0);
      if (KIND != kLinear) {
        if (whole) {
#pragma unroll
          for (int k = 0; k < D; ++k) xn = fma(cur.xv[i][k], cur.xv[i][k], xn);
        } else {
          for (int k = 0; k < d; ++k) {
            const T v = __ldg(x + (size_t)row * d + k);
            xn = fma(v, v, xn);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < VC; ++j) {
        // Past the edges gbar and gt read 0: an entry there adds 0 but
        // for its d2' terms, which it drops (g'' may be infinite there).
        const bool ok = rok && L.cok[j];
        const T gb = cur.gv[i][j];
        T ytj[NB][D];
#pragma unroll
        for (int q = 0; q < NB; ++q)
#pragma unroll
          for (int k = 0; k < D; ++k) ytj[q][k] = yts[q][k][j][lane];
        if (KIND == kLinear) {
#pragma unroll
          for (int q = 0; q < NB; ++q)
#pragma unroll
            for (int k = 0; k < D; ++k) {
              xacc[(i * NB + q) * D + k] += cur.gtv[i][q][j] * yv[j][k] + gb * ytj[q][k];
              yacc[j][q][k] += cur.gtv[i][q][j] * cur.xv[i][k] + gb * cur.xtv[i][q][k];
            }
          continue;
        }
        // d2 by K1's FMA chain, s = <r, rt> per direction, then the terms.
        T r[D], rt[NB][D], s[NB], acc = T(0);
#pragma unroll
        for (int k = 0; k < D; ++k) r[k] = cur.xv[i][k] - yv[j][k];
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          s[q] = T(0);
#pragma unroll
          for (int k = 0; k < D; ++k) rt[q][k] = cur.xtv[i][q][k] - ytj[q][k];
        }
        if (whole) {
#pragma unroll
          for (int k = 0; k < D; ++k) acc = fma(cur.xv[i][k], yv[j][k], acc);
#pragma unroll
          for (int q = 0; q < NB; ++q)
#pragma unroll
            for (int k = 0; k < D; ++k) s[q] = fma(r[k], rt[q][k], s[q]);
        } else {
          for (int k = 0; k < d; ++k) {
            const T xk = __ldg(x + (size_t)row * d + k);
            const T yk = __ldg(y + (size_t)cols[j] * d + k);
            acc = fma(xk, yk, acc);
#pragma unroll
            for (int q = 0; q < NB; ++q) {
              const T xd = L.xtile[q] != nullptr ? __ldg(L.xtile[q] + (size_t)row * d + k) : T(0);
              const T yd = yt != nullptr && q < nb
                               ? __ldg(yt + ((size_t)(q0 + q) * m + cols[j]) * d + k) : T(0);
              s[q] = fma(xk - yk, xd - yd, s[q]);
            }
          }
        }
        T d2 = xn + yn[j] - T(2) * acc;
        const bool flat = d2 < T(0);  // the clamp bites: flat in d2, no d2' terms
        d2 = flat ? T(0) : d2;
        const bool drop = flat || !ok;
        T gp, hv = T(0), gpa = T(0), haa = T(0);
        const T gpp = g_second<KIND, T>(d2, alpha, hia, &gp, &hv, &gpa, &haa);
        const T w = gb * gp;
#pragma unroll
        for (int q = 0; q < NB; ++q) {
          // A d2' of exactly 0 drops its terms (Matérn-1/2's g'' is
          // infinite at coincident points).
          const T gtq = cur.gtv[i][q][j];
          const T dd2 = drop ? T(0) : T(2) * s[q];
          T t = gtq * gp;
          if (dd2 != T(0)) t += gb * gpp * dd2;
          if (KIND == kRq) t += gb * gpa * atv[q];
          if (want_a) {
            T ea = gtq * hv + gb * haa * atv[q];
            if (dd2 != T(0)) ea += gb * gpa * dd2;
            aacc[q] += ea;
          }
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const T tt = fma(t, r[k], w * rt[q][k]);
            xacc[(i * NB + q) * D + k] += tt;
            yacc[j][q][k] -= tt;
          }
        }
      }
    }

    // The warp's lanes share its rows: sum over them (a fixed tree), and
    // one lane writes each entry of the block's x slice, once.
    if (g.want_x) {
      const T sx = halving_sum<P2>(xacc, lane);
      if (writer && r0 + ei < r_end) *xdst = kScale * sx;
    }
    cur = nxt;
  }

  // The warps share the block's columns: sum over them in order, once per
  // (direction, depth), and write the block's y slice.
  if (g.want_y) {
    T* ydst = yw + (size_t)a * ystride;
#pragma unroll
    for (int q = 0; q < NB; ++q)
#pragma unroll
      for (int k = 0; k < D; ++k) {
        if (q >= nb || k0 + k >= d) continue;  // the same for the whole block
#pragma unroll
        for (int j = 0; j < VC; ++j) red[warp][j * 32 + lane] = yacc[j][q][k];
        __syncthreads();
        for (int c = threadIdx.x; c < TN; c += kGramThreads) {
          T sy = red[0][c];
#pragma unroll
          for (int w2 = 1; w2 < kGramWarps; ++w2) sy += red[w2][c];
          const int col = lane_col<T>(c_begin, c % 32, c / 32);
          if (col < c_end) ydst[((size_t)(q0 + q) * m + col) * d + k0 + k] = kScale * sy;
        }
        __syncthreads();
      }
  }

  if (want_a) {
#pragma unroll
    for (int q = 0; q < NB; ++q) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) aacc[q] += __shfl_xor_sync(0xffffffffu, aacc[q], o);
      if (lane == 0) ared[warp][q] = aacc[q];
    }
    __syncthreads();
    if ((int)threadIdx.x < nb) {
      const int q = threadIdx.x;
      T sa = ared[0][q];
#pragma unroll
      for (int w2 = 1; w2 < kGramWarps; ++w2) sa += ared[w2][q];
      aw[((size_t)(q0 + q) * g.splits + a) * g.spans + b] = sa;
    }
  }
}

template <typename T>
struct JvbPtrs {
  const T *x, *y, *gbar, *gt, *xt, *yt, *alpha, *at;
  T *xw, *yw, *aw;
  size_t ystride;
};

template <int KIND, typename T, int NB, int D>
void jvb_sweep(const JvbPtrs<T>& p, const JvbArgs& g, int q0, int nb, int k0, cudaStream_t s) {
  const dim3 grid(g.spans, g.splits);
  constexpr int bytes = kJvbRingBytes<T, NB, D>;
  auto kernel = gram_bwd_jvp_kernel<KIND, T, NB, D>;
  if (bytes > 0) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  kernel<<<grid, kGramThreads, bytes, s>>>(p.x, p.y, p.gbar, p.gt, p.xt, p.yt, p.alpha, p.at,
                                           p.xw, p.yw, p.ystride, p.aw, g, q0, nb, k0);
}

// The sweeps of one call. Depth 1 (the Hessian's): the directions in
// groups of kJvbGroup, one sweep each, the instance sized to the group.
// Deeper: one sweep per direction and depth slice of kJvbDeep.
template <int KIND, typename T>
void jvb_sweeps(const JvbPtrs<T>& p, const JvbArgs& g, cudaStream_t s) {
  if (g.d == 1) {
    for (int q0 = 0; q0 < g.batch; q0 += kJvbGroup) {
      const int nb = g.batch - q0 < kJvbGroup ? g.batch - q0 : kJvbGroup;
      switch (nb) {
        case 1: jvb_sweep<KIND, T, 1, 1>(p, g, q0, nb, 0, s); break;
        case 2: jvb_sweep<KIND, T, 2, 1>(p, g, q0, nb, 0, s); break;
        case 3: jvb_sweep<KIND, T, 3, 1>(p, g, q0, nb, 0, s); break;
        case 4: jvb_sweep<KIND, T, 4, 1>(p, g, q0, nb, 0, s); break;
        default: jvb_sweep<KIND, T, kJvbGroup, 1>(p, g, q0, nb, 0, s); break;
      }
    }
    return;
  }
  for (int q0 = 0; q0 < g.batch; ++q0)
    for (int k0 = 0; k0 < g.d; k0 += kJvbDeep) jvb_sweep<KIND, T, 1, kJvbDeep>(p, g, q0, 1, k0, s);
}

// The sweeps into `work` (the alpha partials into `out`), then the
// fixed-order sums of the slices into `out`.
template <typename T>
cudaError_t jvb_launch(int kind, const void* x, const void* y, const void* gbar, const void* gt,
                       const void* xt, const void* yt, const void* alpha, const void* at,
                       void* outp, void* workp, const JvbArgs& g, cudaStream_t s) {
  T* out = static_cast<T*>(outp);
  T* work = static_cast<T*>(workp);
  const size_t x_slices = g.want_x ? (size_t)g.spans * g.nx : 0;
  JvbPtrs<T> p{static_cast<const T*>(x), static_cast<const T*>(y), static_cast<const T*>(gbar),
               static_cast<const T*>(gt), static_cast<const T*>(xt), static_cast<const T*>(yt),
               static_cast<const T*>(alpha), static_cast<const T*>(at), work,
               work == nullptr ? nullptr : work + x_slices,
               out + (g.want_x ? g.nx : 0) + (g.want_y && !g.fold ? g.ny : 0),
               g.fold ? g.nx : g.ny};
  switch (kind) {
    case kEq: jvb_sweeps<kEq, T>(p, g, s); break;
    case kRq: jvb_sweeps<kRq, T>(p, g, s); break;
    case kMatern12: jvb_sweeps<kMatern12, T>(p, g, s); break;
    case kMatern32: jvb_sweeps<kMatern32, T>(p, g, s); break;
    case kMatern52: jvb_sweeps<kMatern52, T>(p, g, s); break;
    case kLinear: jvb_sweeps<kLinear, T>(p, g, s); break;
    default: return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (g.fold) return reduce_splits<T>(work, out, g.nx, g.spans + g.splits, s);
  if (g.want_x) {
    err = reduce_splits<T>(work, out, g.nx, g.spans, s);
    if (err != cudaSuccess) return err;
  }
  if (g.want_y) return reduce_splits<T>(work + x_slices, out + (g.want_x ? g.nx : 0), g.ny,
                                        g.splits, s);
  return cudaSuccess;
}

}  // namespace
