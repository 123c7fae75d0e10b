// Tile Cholesky (K2) for Hopper, sm_90a, float32.
//
// Replaces the Pallas kernel stheno_tpu/ops/pallas_chol.py:_chol_kernel
// (with _factor_block). For an SPD tile A (n x n, n a multiple of 128,
// n <= 1024) it writes the lower factor L in place of A and the inverses
// of the n/128 diagonal 128-blocks of L, stacked, to dinv (n x 128).
//
// The TPU kernel keeps the whole 1024^2 tile (4 MiB) in VMEM. One SM has
// 227 KB of shared memory, so here the host loops over the diagonal
// blocks and launches three kernels per block:
//   (i)   diag_factor: one thread block factors the 128x128 diagonal
//         block by the 128-step right-looking rank-1 loop and builds that
//         block's inverse by forward substitution in the same loop, with
//         the block and its inverse in dynamic shared memory (2 x 64.5 KB);
//   (ii)  panel: L21 = A21 . Ikk^T, 64 rows per thread block;
//   (iii) trailing: A22 -= L21 . L21^T over the lower 64x64 tiles only.
//
// What bounds it: the 128-step dependency chain of (i). Every step needs
// the previous step's Schur update, so each diagonal block is one thread
// block on one SM with one __syncthreads() per step, and the other 131 SMs
// idle while it runs; (ii) and (iii) are small FP32 products. The design
// does what it can about the chain: the three tasks of a step (rank-1
// update of the trailing block, the new column of L, the new row of the
// inverse) read only what earlier steps finished, so they share that one
// barrier. The column of L is kept transposed in the upper triangle of
// the working block so that no step overwrites what it reads.
//
// All products are FP32 FMAs: one TF32 product on this chain brings back
// the NaN and wrong-gradient failures documented at
// stheno_tpu/config.py:82-101.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 128;       // diagonal block size (the rank-1 loop length)
constexpr int kLd = kT + 1;   // padded shared-memory row: conflict-free column reads
constexpr int kDiagThreads = 1024;
constexpr int kTile = 64;     // rows (and cols) of a panel / trailing tile

// ---------------------------------------------------------------- (i)
__global__ void __launch_bounds__(kDiagThreads)
diag_factor(float* __restrict__ L, float* __restrict__ dinv, int n, int k0) {
  extern __shared__ float smem[];
  float* M = smem;                 // kT x kLd: trailing block, L^T in its upper triangle
  float* Inv = smem + kT * kLd;    // kT x kLd: inverse of the block
  float* diag = Inv + kT * kLd;    // kT: diagonal of L

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  for (int e = tid; e < kT * kT; e += kDiagThreads) {
    const int i = e / kT, c = e % kT;
    M[i * kLd + c] = L[(size_t)(k0 + i) * n + k0 + c];
  }
  __syncthreads();

  for (int j = 0; j < kT; ++j) {
    const float djj = M[j * kLd + j];
    const float dinv_j = rsqrtf(djj);
    // (a) Rank-1 Schur update of the lower trailing block (i >= k > j).
    for (int e = tid; e < kT * kT; e += kDiagThreads) {
      const int i = e / kT, k = e % kT;
      if (k > j && k <= i)
        M[i * kLd + k] -= (M[i * kLd + j] * dinv_j) * (M[k * kLd + j] * dinv_j);
    }
    // (b) Column j of L, stored transposed in row j of the upper triangle.
    if (tid < kT) {
      const int i = tid;
      if (i > j) M[j * kLd + i] = M[i * kLd + j] * dinv_j;
      if (i == j) diag[j] = djj * dinv_j;
    }
    // (c) Row j of the inverse: Inv[j, c] = (delta_jc - sum_{c<=p<j}
    //     L[j, p] Inv[p, c]) / L[j, j], with L[j, p] at M[p, j] (p < j).
    for (int c = warp; c <= j; c += kDiagThreads / 32) {
      float s = 0.f;
      for (int p = c + lane; p < j; p += 32) s = fmaf(M[p * kLd + j], Inv[p * kLd + c], s);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) Inv[j * kLd + c] = ((c == j ? 1.f : 0.f) - s) * dinv_j;
    }
    __syncthreads();
  }

  // L block (zero above its diagonal) and the block inverse.
  for (int e = tid; e < kT * kT; e += kDiagThreads) {
    const int i = e / kT, c = e % kT;
    const float l = c < i ? M[c * kLd + i] : (c == i ? diag[i] : 0.f);
    L[(size_t)(k0 + i) * n + k0 + c] = l;
    dinv[(size_t)(k0 + i) * kT + c] = c <= i ? Inv[i * kLd + c] : 0.f;
  }
  // The rest of these rows lies above the diagonal of L: zero it. Nothing
  // later reads or writes it.
  const int k1 = k0 + kT, w = n - k1;
  for (int e = tid; e < kT * w; e += kDiagThreads) {
    const int i = e / w, c = e % w;
    L[(size_t)(k0 + i) * n + k1 + c] = 0.f;
  }
}

// ---------------------------------------------------------------- (ii)
// L[k1 + r, k0 + c] = sum_p A[k1 + r, k0 + p] * Ikk[c, p], in place: the
// block stages all 128 columns of its 64 rows before it writes any.
__global__ void __launch_bounds__(256)
panel(float* __restrict__ L, const float* __restrict__ dinv, int n, int k0) {
  extern __shared__ float smem[];
  float* As = smem;                // kTile x kLd
  float* Is = smem + kTile * kLd;  // kT x kLd
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 32 + tx;
  const int k1 = k0 + kT;
  const int r0 = k1 + blockIdx.x * kTile;

  for (int e = tid; e < kTile * kT; e += 256) {
    const int r = e / kT, p = e % kT;
    As[r * kLd + p] = L[(size_t)(r0 + r) * n + k0 + p];
  }
  for (int e = tid; e < kT * kT; e += 256) {
    const int c = e / kT, p = e % kT;
    Is[c * kLd + p] = dinv[(size_t)(k0 + c) * kT + p];
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int p = 0; p < kT; ++p) {
    float a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = As[(ty + 8 * i) * kLd + p];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = Is[(tx + 32 * j) * kLd + p];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      L[(size_t)(r0 + ty + 8 * i) * n + k0 + tx + 32 * j] = acc[i][j];
}

// ---------------------------------------------------------------- (iii)
// L[k1 + R, k1 + C] -= sum_p L21[R, p] L21[C, p] for the 64x64 tile
// (blockIdx.y, blockIdx.x) of the trailing block, lower tiles only.
__global__ void __launch_bounds__(256)
trailing(float* __restrict__ L, int n, int k0) {
  const int bi = blockIdx.y, bj = blockIdx.x;
  if (bj > bi) return;
  extern __shared__ float smem[];
  float* Lr = smem;                // kTile x kLd
  float* Lc = smem + kTile * kLd;  // kTile x kLd
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * 32 + tx;
  const int k1 = k0 + kT;
  const int r0 = k1 + bi * kTile, c0 = k1 + bj * kTile;

  for (int e = tid; e < kTile * kT; e += 256) {
    const int r = e / kT, p = e % kT;
    Lr[r * kLd + p] = L[(size_t)(r0 + r) * n + k0 + p];
    Lc[r * kLd + p] = L[(size_t)(c0 + r) * n + k0 + p];
  }
  __syncthreads();

  float acc[8][2];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = 0.f;
  for (int p = 0; p < kT; ++p) {
    float a[8], b[2];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = Lr[(ty + 8 * i) * kLd + p];
#pragma unroll
    for (int j = 0; j < 2; ++j) b[j] = Lc[(tx + 32 * j) * kLd + p];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* dst = L + (size_t)(r0 + ty + 8 * i) * n + c0 + tx + 32 * j;
      *dst = *dst - acc[i][j];
    }
}

constexpr size_t kDiagSmem = (2 * kT * kLd + kT) * sizeof(float);
constexpr size_t kPanelSmem = (kTile + kT) * kLd * sizeof(float);
constexpr size_t kTrailSmem = 2 * kTile * kLd * sizeof(float);

}  // namespace

// Factors the n x n float32 tile in `L` in place (n a positive multiple of
// 128) and writes the stacked diagonal-block inverses to `dinv` (n x 128),
// launching on `stream`. The host loop over the diagonal blocks is here.
// Returns the first non-zero cudaGetLastError(), else 0.
extern "C" int stheno_chol_tile(void* L_, void* dinv_, int n, void* stream) {
  if (n <= 0 || n % kT != 0) return (int)cudaErrorInvalidValue;
  float* L = static_cast<float*>(L_);
  float* dinv = static_cast<float*>(dinv_);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(diag_factor, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kDiagSmem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(panel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kPanelSmem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaFuncSetAttribute(trailing, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kTrailSmem)) != cudaSuccess)
    return (int)err;
  const int nb = n / kT;
  for (int kb = 0; kb < nb; ++kb) {
    const int k0 = kb * kT;
    diag_factor<<<1, kDiagThreads, kDiagSmem, s>>>(L, dinv, n, k0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    if (kb + 1 == nb) break;
    const int rows = n - k0 - kT;  // a multiple of 128
    panel<<<rows / kTile, dim3(32, 8), kPanelSmem, s>>>(L, dinv, n, k0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    const int nt = rows / kTile;
    trailing<<<dim3(nt, nt), dim3(32, 8), kTrailSmem, s>>>(L, n, k0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
