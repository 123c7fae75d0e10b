// Tile Cholesky (K2) for Hopper, sm_90a, float32.
//
// Replaces the Pallas kernel stheno_tpu/ops/pallas_chol.py:_chol_kernel
// (with _factor_block). For an SPD tile A (n x n, n a multiple of 128,
// n <= 1024) it writes the lower factor L in place of A and the inverses
// of the n/128 diagonal 128-blocks of L, stacked, to dinv (n x 128).
//
// What bounds it: not operations (2n^3/3 = 0.7 GFLOP at n = 1024, 11 us
// at the FP32 rate) but the dependency chain of the factorisation: every
// column needs the Schur update of the one before. The design shortens
// that chain and keeps the rest of the card busy:
//   - one kernel per diagonal 128-block, factor_panel, factors the block
//     in shared memory in four 32-wide sub-steps. In each, ONE WARP
//     factors the 32x32 diagonal sub-block with a row per lane in
//     registers (pivots and columns broadcast by __shfl_sync, no
//     __syncthreads inside the 32-step chain); then every warp inverts
//     four of its columns by the 32-step row sweep (the columns are
//     independent), and all eight warps form the sub-panel (A21 X^T) and
//     the symmetric rank-32 update below it. Four block barriers per
//     32-column sub-step, none per column;
//   - the 128-block inverse is then built from the four 32-block
//     inverses by products only, in the log-depth order of
//     _assemble_inv (ops/chol_tile.py): I21 = -(I22 (L21 I11)), 32 -> 64
//     -> 128, skipping the zero triangles;
//   - every shared-memory product holds a 4x4 (or 2x4) tile of outputs in
//     registers, so a pair of loads feeds four FMAs or more;
//   - the same kernel then forms the panel below the block, L21 = A21
//     Ikk^T, 32 rows per thread block. Every thread block of the launch
//     factors the diagonal block itself (the factor is deterministic, so
//     all agree bit for bit): SMs that would idle during the chain do
//     the same chain, and the panel needs no second launch. Only block 0
//     writes the factor (to the scratch `ld`, since the other blocks
//     still read the diagonal block of L) and the block inverse;
//   - trailing: A22 -= L21 L21^T over the lower 64x64 tiles;
//   - finalize, once per tile: copies the diagonal blocks from `ld` into
//     L and from `dinv` into the full inverse, and zeroes everything
//     above the diagonal of both;
//   - the full inverse is joined here by join_product in the order of
//     _assemble_inv (the Python version is the plain one), two launches
//     per level of its tree, each taking all the level's joins: the
//     wrapper makes one call into the library and no torch operation per
//     join (torch operations from Python host-bound the tile at about 30
//     us each).
// Launches per tile at n = 1024: 8 factor_panel, 7 trailing, 1 finalize,
// 6 join_product.
//
// All products are FP32 FMAs: one TF32 product on this chain brings back
// the NaN and wrong-gradient failures documented at
// stheno_tpu/config.py:82-101.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 128;       // diagonal block size
constexpr int kS = 32;        // sub-block one warp factors
constexpr int kLd = kT + 1;   // padded shared-memory row: conflict-free column reads
constexpr int kThreads = 256; // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;     // panel rows per thread block
constexpr int kTile = 64;     // rows (and cols) of a trailing tile
constexpr int kTmp = kT - kS; // rows of the staging area: the largest sub-panel
constexpr unsigned kFull = 0xffffffffu;

// dst[r][c] (+)= sign * sum_u A(r, u) B(u, c) for r < rows, c < cols,
// u < depth, all in shared memory (row stride kLd), by threads lt = 0 ..
// nt - 1 of the block, each an RI x CJ register tile of rows tr + TR i and
// columns tc + TC j (so a warp's reads are broadcasts or conflict-free).
// B(u, c) is b[u][c], or b[c][u] if BT. TRI_A: A is lower triangular,
// so u stops at the tile's last row; TRI_B: b is lower triangular, so u
// starts at the tile's first column (or, with BT, stops at its last).
// LOWER: only c <= r is written.
// u ascending, FP32 FMA.
template <int RI, int CJ, bool BT, bool ACC, bool TRI_A, bool TRI_B, bool LOWER>
__device__ __forceinline__ void tile_product(float* dst, const float* a, const float* b,
                                             int rows, int cols, int depth, float sign, int lt,
                                             int nt) {
  const int TR = rows / RI, TC = cols / CJ;
  for (int tile = lt; tile < TR * TC; tile += nt) {
    const int tr = tile / TC, tc = tile % TC;
    float acc[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) acc[i][j] = 0.f;
    const int u0 = TRI_B && !BT ? tc : 0;
    int u1 = TRI_A ? min(depth, tr + TR * (RI - 1) + 1) : depth;
    if (TRI_B && BT) u1 = min(u1, tc + TC * (CJ - 1) + 1);
#pragma unroll 4
    for (int u = u0; u < u1; ++u) {
      float av[RI], bv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) av[i] = a[(tr + TR * i) * kLd + u];
#pragma unroll
      for (int j = 0; j < CJ; ++j) bv[j] = BT ? b[(tc + TC * j) * kLd + u] : b[u * kLd + tc + TC * j];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int r = tr + TR * i, c = tc + TC * j;
        if (LOWER && c > r) continue;
        float* o = dst + r * kLd + c;
        *o = ACC ? *o + sign * acc[i][j] : sign * acc[i][j];
      }
  }
}

// dst[r][c] = src[r][c] (row strides kLd and ld_src) for r < ROWS, c <
// kT, by the block's kThreads threads (tid its flat index): every thread
// issues all its 16-byte loads before its first store, so their
// latencies overlap. With LOWER, c > r is stored as 0.
template <int ROWS, bool LOWER>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src,
                                          size_t ld_src, int tid) {
  constexpr int kPer = ROWS * kT / 4 / kThreads;
  float4 buf[kPer];
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    const int e = tid + kThreads * it, r = e / (kT / 4), c = 4 * (e % (kT / 4));
    buf[it] = *reinterpret_cast<const float4*>(src + r * ld_src + c);
  }
#pragma unroll
  for (int it = 0; it < kPer; ++it) {
    const int e = tid + kThreads * it, r = e / (kT / 4), c = 4 * (e % (kT / 4));
    float* o = dst + r * kLd + c;
    o[0] = !LOWER || c <= r ? buf[it].x : 0.f;
    o[1] = !LOWER || c + 1 <= r ? buf[it].y : 0.f;
    o[2] = !LOWER || c + 2 <= r ? buf[it].z : 0.f;
    o[3] = !LOWER || c + 3 <= r ? buf[it].w : 0.f;
  }
}

// One warp: factor the 32x32 block at M[c0.., c0..] (lower triangle
// read) by the right-looking rank-1 loop, a row per lane; the factor goes
// back to M (zero above its diagonal), the rsqrt of each pivot (1 /
// L[j][j]) to rinv.
__device__ __forceinline__ void warp_factor(float* M, float* rinv, int c0, int lane) {
  float a[kS];
  float* row = M + (c0 + lane) * kLd + c0;
#pragma unroll
  for (int q = 0; q < kS; ++q) a[q] = q <= lane ? row[q] : 0.f;
#pragma unroll
  for (int j = 0; j < kS; ++j) {
    const float piv = __shfl_sync(kFull, a[j], j);
    const float r = rsqrtf(piv);
    if (lane == j) rinv[c0 + j] = r;
    const float l = lane >= j ? a[j] * r : 0.f;
    a[j] = l;
    // All of the step's broadcasts first, then its updates: interleaved,
    // every FMA would wait out its shuffle's latency in turn.
    float lk[kS];
#pragma unroll
    for (int k = j + 1; k < kS; ++k) lk[k] = __shfl_sync(kFull, l, k);
#pragma unroll
    for (int k = j + 1; k < kS; ++k)
      if (lane >= k) a[k] = fmaf(-l, lk[k], a[k]);
  }
#pragma unroll
  for (int q = 0; q < kS; ++q) row[q] = a[q];
}

// Every warp: columns warp, warp + 8, .. of the inverse of the 32x32
// factor at M[c0.., c0..], into Inv at the same place, by the row sweep
// (row p scaled by rinv[p] is final; every later row takes its multiple
// of it), a row per lane. Columns are independent, so the warps split
// them and each chain carries four.
__device__ __forceinline__ void warp_invert(const float* M, const float* rinv, float* Inv,
                                            int c0, int lane, int warp) {
  constexpr int kC = kS / kWarps;
  float a[kS], x[kC];
  const float* row = M + (c0 + lane) * kLd + c0;
#pragma unroll
  for (int q = 0; q < kS; ++q) a[q] = row[q];
#pragma unroll
  for (int jj = 0; jj < kC; ++jj) x[jj] = lane == warp + kWarps * jj ? 1.f : 0.f;
#pragma unroll
  for (int p = 0; p < kS; ++p) {
    const float rp = rinv[c0 + p];
#pragma unroll
    for (int jj = 0; jj < kC; ++jj) {
      const float xp = __shfl_sync(kFull, x[jj], p) * rp;
      if (lane == p) x[jj] = xp;
      if (lane > p) x[jj] = fmaf(-a[p], xp, x[jj]);
    }
  }
  float* irow = Inv + (c0 + lane) * kLd + c0;
#pragma unroll
  for (int jj = 0; jj < kC; ++jj) irow[warp + kWarps * jj] = x[jj];
}

// ---------------------------------------------------------------- (i)
__global__ void __launch_bounds__(kThreads)
factor_panel(float* __restrict__ L, float* __restrict__ dinv, float* __restrict__ ld, int n,
             int k0) {
  extern __shared__ float smem[];
  float* M = smem;               // kT x kLd: the diagonal block, then its factor
  float* Inv = M + kT * kLd;     // kT x kLd: the block inverse
  float* Tmp = Inv + kT * kLd;   // kTmp x kLd: sub-panels, products, panel rows
  float* rinv = Tmp + kTmp * kLd;  // kT: 1 / L[j][j]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  load_rows<kT, true>(M, L + (size_t)k0 * n + k0, n, tid);
  for (int e = tid; e < kT * kT; e += kThreads) Inv[(e / kT) * kLd + e % kT] = 0.f;
  __syncthreads();

  for (int c0 = 0; c0 < kT; c0 += kS) {
    if (warp == 0) warp_factor(M, rinv, c0, lane);
    __syncthreads();
    warp_invert(M, rinv, Inv, c0, lane, warp);
    __syncthreads();
    const int b0 = c0 + kS, R = kT - b0;  // rows below the sub-block
    if (R == 0) break;
    // Sub-panel P = A21 X^T (X the sub-block inverse, lower) into Tmp.
    tile_product<4, 4, true, false, false, true, false>(Tmp, M + b0 * kLd + c0,
                                                        Inv + c0 * kLd + c0, R, kS, kS, 1.f,
                                                        tid, kThreads);
    __syncthreads();
    // P back into M, and the symmetric rank-32 update of the lower
    // trailing part of the block from P.
    for (int e = tid; e < R * kS; e += kThreads)
      M[(b0 + e / kS) * kLd + c0 + e % kS] = Tmp[(e / kS) * kLd + e % kS];
    tile_product<4, 4, true, true, false, false, true>(M + b0 * kLd + b0, Tmp, Tmp, R, R, kS,
                                                       -1.f, tid, kThreads);
    __syncthreads();
  }

  // Block inverse from the 32-block inverses: I21 = -(I22 (L21 I11)),
  // pairs (0, 1) and (2, 3) of 32 (half the block each), then (0, 1) of
  // 64.
  {
    const int half = tid >> 7, lt = tid & 127, lo = 2 * kS * half, hi = lo + kS;
    tile_product<2, 4, false, false, false, true, false>(Tmp + lo * kLd, M + hi * kLd + lo,
                                                         Inv + lo * kLd + lo, kS, kS, kS, 1.f,
                                                         lt, 128);
    __syncthreads();
    tile_product<2, 4, false, false, true, false, false>(Inv + hi * kLd + lo, Inv + hi * kLd + hi,
                                                         Tmp + lo * kLd, kS, kS, kS, -1.f, lt,
                                                         128);
    __syncthreads();
    constexpr int w = 2 * kS;
    tile_product<4, 4, false, false, false, true, false>(Tmp, M + w * kLd, Inv, w, w, w, 1.f, tid,
                                                         kThreads);
    __syncthreads();
    tile_product<4, 4, false, false, true, false, false>(Inv + w * kLd, Inv + w * kLd + w, Tmp, w,
                                                         w, w, -1.f, tid, kThreads);
    __syncthreads();
  }

  if (blockIdx.x == 0) {
    for (int e = tid; e < kT * kT; e += kThreads) {
      const int i = e / kT, c = e % kT;
      ld[(size_t)(k0 + i) * kT + c] = M[i * kLd + c];
      dinv[(size_t)(k0 + i) * kT + c] = Inv[i * kLd + c];
    }
  }

  // Panel rows of this thread block: L[r][k0 + q] = sum_u A[r][k0 + u]
  // Ikk[q][u], a 4x4 register tile per thread.
  const int r0 = k0 + kT + blockIdx.x * kRows;
  if (r0 >= n) return;
  load_rows<kRows, false>(Tmp, L + (size_t)r0 * n + k0, n, tid);
  __syncthreads();
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int u = 0; u < kT; ++u) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = Tmp[(warp + kWarps * i) * kLd + u];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Inv[(lane + 32 * j) * kLd + u];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      L[(size_t)(r0 + warp + kWarps * i) * n + k0 + lane + 32 * j] = acc[i][j];
}

// ---------------------------------------------------------------- (ii)
// L[k1 + R, k1 + C] -= sum_p L21[R, p] L21[C, p] for the 64x64 tile
// (blockIdx.y, blockIdx.x) of the trailing block, lower tiles only; a
// 4x4 register tile per thread.
__global__ void __launch_bounds__(kThreads)
trailing(float* __restrict__ L, int n, int k0) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bj > bi) return;
  extern __shared__ float smem[];
  float* Lr = smem;                // kTile x kLd
  float* Lc = smem + kTile * kLd;  // kTile x kLd
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k1 = k0 + kT;
  const int r0 = k1 + bi * kTile, c0 = k1 + bj * kTile;
  load_rows<kTile, false>(Lr, L + (size_t)r0 * n + k0, n, tid);
  load_rows<kTile, false>(Lc, L + (size_t)c0 * n + k0, n, tid);
  __syncthreads();

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int p = 0; p < kT; ++p) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = Lr[(ty + 16 * i) * kLd + p];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Lc[(tx + 16 * j) * kLd + p];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = L + (size_t)(r0 + ty + 16 * i) * n + c0 + tx + 16 * j;
      *dst = *dst - acc[i][j];
    }
}

// ---------------------------------------------------------------- (iii)
// The diagonal blocks of L from `ld` and of inv(L) from `dinv`; zero
// above the diagonal of both. The joins fill inv(L) below its diagonal
// blocks.
__global__ void finalize(float* __restrict__ L, float* __restrict__ Linv,
                         const float* __restrict__ ld, const float* __restrict__ dinv, int n) {
  const size_t count = (size_t)n * n;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    const int i = (int)(e / n), c = (int)(e % n);
    const int k0 = i / kT * kT;
    if (c > i) {
      L[e] = 0.f;
      Linv[e] = 0.f;
    } else if (c >= k0) {
      L[e] = ld[(size_t)i * kT + c - k0];
      Linv[e] = dinv[(size_t)i * kT + c - k0];
    }
  }
}

// ---------------------------------------------------------------- (iv)
// The joins of one level of _assemble_inv's tree (ops/chol_tile.py),
// over diagonal blocks [lo, mid) and [mid, hi): I21 = -(I22 (L21 I11)).
// Joins of one level are independent (each reads only deeper levels), so
// one launch takes them all, blockIdx.z the join. At most four per level
// for n <= 1024.
constexpr int kMaxJoins = 4;
struct Joins {
  int count;
  int lo[kMaxJoins], mid[kMaxJoins], hi[kMaxJoins];
};

// One product of each join, a 64x64 output tile per block, k in chunks
// of 32 staged in shared memory, a 4x4 register tile per thread, FP32
// FMA, all matrices row-major with row stride n. FIRST: T = L21 I11 (I11
// lower: k starts at the tile's first column), written to the scratch T
// at the join's own place; else I21 = -(I22 T) (I22 lower: k stops at
// the tile's last row).
template <bool FIRST>
__global__ void __launch_bounds__(256)
join_product(const float* __restrict__ L, float* __restrict__ Linv, float* __restrict__ T, int n,
             Joins joins) {
  constexpr int kJ = 64, kK = 32;
  __shared__ float As[kJ][kK + 1];
  __shared__ __align__(16) float Bs[kK][kJ];
  const int z = blockIdx.z;
  const int a = joins.lo[z] * kT, m = joins.mid[z] * kT, b = joins.hi[z] * kT;
  const int r0 = blockIdx.y * kJ, c0 = blockIdx.x * kJ;
  if (r0 >= b - m || c0 >= m - a) return;
  const float* A = FIRST ? L + (size_t)m * n + a : Linv + (size_t)m * n + m;
  const float* B = FIRST ? Linv + (size_t)a * n + a : T + (size_t)m * n + a;
  float* D = FIRST ? T + (size_t)m * n + a : Linv + (size_t)m * n + a;
  const int K = FIRST ? m - a : b - m;
  const int k_begin = FIRST ? c0 : 0;
  const int k_end = FIRST ? K : min(K, r0 + kJ);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float acc[4][4] = {};
  // 512 float4 of A (64 x 32) and of B (32 x 64) per chunk, two of each
  // per thread; the next chunk's are loaded while this one is multiplied.
  float4 av4[2], bv4[2];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int e = tid + 256 * it;
      av4[it] = *reinterpret_cast<const float4*>(A + (size_t)(r0 + e / 8) * n + k0 + 4 * (e % 8));
      bv4[it] = *reinterpret_cast<const float4*>(B + (size_t)(k0 + e / 16) * n + c0 + 4 * (e % 16));
    }
  };
  if (k_begin < k_end) fetch(k_begin);
  for (int k0 = k_begin; k0 < k_end; k0 += kK) {
#pragma unroll
    for (int it = 0; it < 2; ++it) {
      const int e = tid + 256 * it;
      float* ar = &As[e / 8][4 * (e % 8)];
      ar[0] = av4[it].x; ar[1] = av4[it].y; ar[2] = av4[it].z; ar[3] = av4[it].w;
      *reinterpret_cast<float4*>(&Bs[e / 16][4 * (e % 16)]) = bv4[it];
    }
    __syncthreads();
    if (k0 + kK < k_end) fetch(k0 + kK);
#pragma unroll 8
    for (int k = 0; k < kK; ++k) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const float sign = FIRST ? 1.f : -1.f;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      D[(size_t)(r0 + ty + 16 * i) * n + c0 + tx + 16 * j] = sign * acc[i][j];
}

// Collects the joins of [lo, hi) by depth below the root.
void collect(Joins* levels, int depth, int lo, int hi, int* max_depth, bool* ok) {
  if (hi - lo == 1) return;
  const int mid = (lo + hi + 1) / 2;
  collect(levels, depth + 1, lo, mid, max_depth, ok);
  collect(levels, depth + 1, mid, hi, max_depth, ok);
  Joins& j = levels[depth];
  if (j.count == kMaxJoins) {
    *ok = false;
    return;
  }
  j.lo[j.count] = lo;
  j.mid[j.count] = mid;
  j.hi[j.count] = hi;
  ++j.count;
  if (depth > *max_depth) *max_depth = depth;
}

// The joins of inv(L) over all nb diagonal blocks, deepest level first,
// two launches per level; T (n x n) is scratch.
cudaError_t join_all(const float* L, float* Linv, float* T, int n, int nb, cudaStream_t s) {
  Joins levels[8] = {};
  int max_depth = -1;
  bool ok = true;
  collect(levels, 0, 0, nb, &max_depth, &ok);
  if (!ok || max_depth >= 8) return cudaErrorInvalidValue;
  cudaError_t err;
  for (int depth = max_depth; depth >= 0; --depth) {
    const Joins& j = levels[depth];
    int rows = 0, cols = 0;
    for (int q = 0; q < j.count; ++q) {
      const int r = (j.hi[q] - j.mid[q]) * kT / 64, c = (j.mid[q] - j.lo[q]) * kT / 64;
      rows = r > rows ? r : rows;
      cols = c > cols ? c : cols;
    }
    const dim3 grid(cols, rows, j.count);
    join_product<true><<<grid, 256, 0, s>>>(L, Linv, T, n, j);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    join_product<false><<<grid, 256, 0, s>>>(L, Linv, T, n, j);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

constexpr size_t kFactorSmem = ((2 * kT + kTmp) * kLd + kT) * sizeof(float);
constexpr size_t kTrailSmem = 2 * kTile * kLd * sizeof(float);

}  // namespace

// Factors the n x n float32 tile in `L` in place (n a positive multiple of
// 128), writes the stacked diagonal-block inverses to `dinv` (n x 128)
// and the full inverse to `Linv` (n x n), with `ld` (n x 128) and `T`
// (n x n) as scratch, launching on `stream`. The host loops over the
// diagonal blocks and the joins are here. Returns the first non-zero
// cudaGetLastError(), else 0.
extern "C" int stheno_chol_tile(void* L_, void* dinv_, void* Linv_, void* ld_, void* T_, int n,
                                void* stream) {
  if (n <= 0 || n % kT != 0 || n > 8 * kT) return (int)cudaErrorInvalidValue;
  float* L = static_cast<float*>(L_);
  float* dinv = static_cast<float*>(dinv_);
  float* Linv = static_cast<float*>(Linv_);
  float* ld = static_cast<float*>(ld_);
  float* T = static_cast<float*>(T_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(factor_panel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kFactorSmem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(trailing, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kTrailSmem)) != cudaSuccess)
    return (int)err;
  const int nb = n / kT;
  for (int kb = 0; kb < nb; ++kb) {
    const int k0 = kb * kT;
    const int rows = n - k0 - kT;  // a multiple of 128
    factor_panel<<<rows > 0 ? rows / kRows : 1, kThreads, kFactorSmem, s>>>(L, dinv, ld, n, k0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (rows == 0) break;
    const int nt = rows / kTile;
    trailing<<<dim3(nt, nt), kThreads, kTrailSmem, s>>>(L, n, k0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const size_t count = (size_t)n * n;
  finalize<<<(int)((count + 255) / 256 < 1024 ? (count + 255) / 256 : 1024), 256, 0, s>>>(
      L, Linv, ld, dinv, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)join_all(L, Linv, T, n, nb, s);
}
