// Fused Gram x V (K3) on the tensor cores, for float32 with p >= 17, sm_90a.
//
// Replaces, with gram_matvec.cu, the Pallas kernel
// stheno_tpu/ops/gram_matvec.py:_gmv_kernel, which ran the product on the
// TPU's matrix unit at Precision.HIGHEST (about float32 accuracy from
// multi-pass bf16). This is the Hopper counterpart of that product: out =
// G @ v with G[i, j] = g(||x_i - y_j||^2) (or x_i.y_j for linear), G never
// stored, and each product formed as a split-precision TF32 product
// (3xTF32) on the tensor cores with FP32 accumulation:
//   G v ~ G_hi v_hi + G_hi v_lo + G_lo v_hi,
// where z_hi = rna_tf32(z) and z_lo = tf32(z - z_hi), truncated (see
// split_tf32). The dropped G_lo v_lo and the truncation are below 2^-20
// of the product, so each term keeps about float32 accuracy; a single
// TF32 product (2^-11) would not, and is what stheno_tpu/config.py:82-101
// warns against.
//
// What bounds it: at p = 64 and 256, the three products (6 n m p flops at
// 495 TFLOP/s dense TF32); at p = 17, the one exp per Gram entry (16 per
// clock per SM). FP32 FMAs (2.5x the bound at p = 64 and 256 in the
// FFMA kernel) cannot reach either, and neither could mma.sync here: a
// first version of this kernel on mma.sync.m16n8k8 ran at 0.29 MMA per
// clock per SM (p = 256 in 0.81 s against 0.42 s for this one, on an
// H100 80GB HBM3 at 700 W).
//
// Design: wgmma.m64nNk8 with the Gram tile as the register A operand.
//   - gmv_split_v runs first, once per call: it splits v into its TF32
//     high and low parts and writes them, zero-padded, in the order in
//     which the tiles of each pass (64 columns of y, 8 k-steps) and each
//     p-split (NB = 24, 32, 64 or 128 output columns) sit in shared
//     memory: wgmma's K-major layout without swizzle (8-row core
//     matrices of 16 bytes; 128 bytes between the two k-halves, 256
//     bytes between 8-row groups). A block then copies each pass's two
//     tiles with 16-byte cp.async, double-buffered, one pass ahead.
//   - a block is two warpgroups, 128 rows; each warp builds the A
//     fragment of its 16 rows per k-step in FP32 registers (norms, inner
//     product, epilogue of gram_kind.cuh, so d2 is exactly 0 where x is
//     y), splits it, and its warpgroup issues the three wgmmas (lo.hi,
//     hi.lo, hi.hi) into one accumulator of 64 x NB: the Gram tile never
//     goes to shared memory;
//   - each pass starts its accumulator from zero (scale-d = 0 on its
//     first wgmma) and then adds it to the running total (the two-level
//     sum of gram_matvec.cu); ragged edges are masked (padded columns of
//     v are zero, rows beyond n are not written); where rows are few the
//     column sweep splits over blockIdx.z and gmv_reduce adds the parts in
//     a fixed order. No atomics: the operator is the same on every call,
//     as CG wants.

#include <stdint.h>

#include "gram_matvec.cuh"

namespace {

constexpr int kWgThreads = 256;  // two warpgroups
constexpr int kWgRows = 128;     // rows per block: 64 per warpgroup
constexpr int kCols = 64;        // columns of y per pass (8 k-steps)

// Offset (in floats) of v[pass column k][split column c] in a pass tile of
// NB columns: k-step, 8-row group of the NB columns, k-half, row, element.
__host__ __device__ __forceinline__ int tile_offset(int k, int c, int nb) {
  return (k >> 3) * (nb * 8) + (c >> 3) * 64 + ((k >> 2) & 1) * 32 + (c & 7) * 4 + (k & 3);
}

// z = hi + lo: hi is z rounded to TF32 to nearest, ties away (the
// result of cvt.rna.tf32.f32, by an integer add and mask: full-rate
// integer operations where the conversion is not), lo = z - hi exactly in
// float32, handed to the MMA as is, which reads its TF32 part (the low 13
// bits are not used: lo is truncated, an error below 2^-21 of z).
__device__ __forceinline__ void split_tf32(float z, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(z) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(z - __uint_as_float(hi));
}

// vh, vl: for every pass and p-split (pass-major), a tile of kCols x nb
// in tile_offset order.
__global__ void gmv_split_v(const float* __restrict__ v, float* __restrict__ vh,
                            float* __restrict__ vl, int m, int p, int nb, int psplits,
                            size_t count) {
  const int tile = kCols * nb;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < count;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t chunk = e / tile;
    const int w = (int)(e % tile), k = w / nb, c = w % nb;
    const int j = (int)(chunk / psplits) * kCols + k, col = (int)(chunk % psplits) * nb + c;
    const float val = j < m && col < p ? v[(size_t)j * p + col] : 0.f;
    uint32_t hi, lo;
    split_tf32(val, hi, lo);
    const size_t o = chunk * tile + tile_offset(k, c, nb);
    vh[o] = __uint_as_float(hi);
    vl[o] = __uint_as_float(lo);
  }
}

// Shared-memory matrix descriptor of a K-major tile without swizzle:
// start address, 128 bytes between k-halves (leading byte offset), 256
// bytes between 8-row groups (stride byte offset).
__device__ __forceinline__ uint64_t tile_desc(const float* tile) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(tile);
  return (uint64_t)((addr & 0x3ffff) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<24> {
  __device__ __forceinline__ static void run(float (&d)[12], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
        : "memory");
  }
};

template <>
struct Wgmma<32> {
  __device__ __forceinline__ static void run(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
        : "memory");
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
        : "memory");
  }
};

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], const uint32_t (&a)[4], uint64_t desc,
                                             int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate)
        : "memory");
  }
};

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool live) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int NB, int DS>
__host__ __device__ constexpr int mma_smem_floats() {
  // two stages of (v_hi tile, v_lo tile, y) and 32 floats of alignment slack
  return 2 * (2 * kCols * NB + kCols * DS) + 32;
}

// D > 0: depth D, x in registers and y staged; D == 0: any depth d, read
// from global memory per entry (the general path; the iterative path has
// d = 1).
template <int KIND, int D, int NB>
__global__ void __launch_bounds__(kWgThreads)
gmv_mma_kernel(const float* __restrict__ x, const float* __restrict__ y,
               const float* __restrict__ vh, const float* __restrict__ vl,
               float* __restrict__ dst, int n, int m, int d, int p, int span, float alpha) {
  constexpr int DS = D > 0 ? D : 1;
  constexpr int TILE = kCols * NB;     // floats of one v tile
  constexpr int STAGE = 2 * TILE + kCols * DS;
  extern __shared__ float smem_raw[];
  // 128-byte aligned base: the tiles' descriptors address 16-byte units.
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~static_cast<uintptr_t>(127));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int psplits = gridDim.y, split = blockIdx.y;
  const int c0 = split * NB;
  const int col_begin = blockIdx.z * span;
  const int col_end = min(m, col_begin + span);

  // The thread's two rows: warp w owns rows 16 w .. 16 w + 15 of the
  // block (warps 0-3 the first warpgroup, 4-7 the second); half h -> row
  // 16 w + 8 h + g.
  int rows[2];
  float xr[2][DS], xn[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = blockIdx.x * kWgRows + warp * 16 + h * 8 + g;
    rows[h] = r;
    const bool live = r < n;
    float s = 0.f;
    if (D > 0) {
#pragma unroll
      for (int k = 0; k < DS; ++k) {
        xr[h][k] = live ? x[(size_t)r * D + k] : 0.f;
        s = fmaf(xr[h][k], xr[h][k], s);
      }
    } else if (live) {
      for (int k = 0; k < d; ++k) {
        const float xv = x[(size_t)r * d + k];
        s = fmaf(xv, xv, s);
      }
    }
    xn[h] = s;
  }

  auto stage = [&](int j0, int buf) {
    float* base = smem + buf * STAGE;
    const size_t chunk = (size_t)(j0 / kCols) * psplits + split;
    const float* sh = vh + chunk * TILE;
    const float* sl = vl + chunk * TILE;
    for (int e = tid; e < TILE / 4; e += kWgThreads) {
      cp_async16(base + 4 * e, sh + 4 * e);
      cp_async16(base + TILE + 4 * e, sl + 4 * e);
    }
    if (D > 0) {
      for (int e = tid; e < kCols * D; e += kWgThreads) {
        const int j = j0 + e / D;
        const bool live = j < col_end;
        cp_async4(base + 2 * TILE + e, live ? y + (size_t)j * D + e % D : y, live);
      }
    }
  };

  float total[NB / 2], part[NB / 2];
#pragma unroll
  for (int q = 0; q < NB / 2; ++q) total[q] = 0.f;

  stage(col_begin, 0);
  cp_async_commit();
  for (int it = 0, j0 = col_begin; j0 < col_end; ++it, j0 += kCols) {
    const int buf = it & 1;
    __syncthreads();  // every warp is done with the other buffer
    if (j0 + kCols < col_end) stage(j0 + kCols, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // this pass's tiles have landed
    fence_proxy_async();  // and are visible to the tensor cores
    __syncthreads();
    const float* bh = smem + buf * STAGE;
    const float* bl = bh + TILE;
    const float* ys = bh + 2 * TILE;

#pragma unroll 2
    for (int ks = 0; ks < kCols / 8; ++ks) {
      // A fragment: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4).
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int jl = ks * 8 + t + 4 * cc;
        float yv[DS], ynj = 0.f;
        if (D > 0) {
#pragma unroll
          for (int k = 0; k < DS; ++k) {
            yv[k] = ys[jl * DS + k];
            ynj = fmaf(yv[k], yv[k], ynj);
          }
        } else if (j0 + jl < col_end) {
          for (int k = 0; k < d; ++k) {
            const float w = y[(size_t)(j0 + jl) * d + k];
            ynj = fmaf(w, w, ynj);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float inner = 0.f;
          if (D > 0) {
#pragma unroll
            for (int k = 0; k < DS; ++k) inner = fmaf(xr[h][k], yv[k], inner);
          } else if (rows[h] < n && j0 + jl < col_end) {
            for (int k = 0; k < d; ++k)
              inner = fmaf(x[(size_t)rows[h] * d + k], y[(size_t)(j0 + jl) * d + k], inner);
          }
          const float gv = epilogue<KIND, float>(xn[h] + ynj - 2.f * inner, inner, alpha);
          split_tf32(gv, ahi[2 * cc + h], alo[2 * cc + h]);
        }
      }
      const int koff = ks * NB * 8;  // this k-step's slice of both tiles
      wgmma_fence();
      Wgmma<NB>::run(part, alo, tile_desc(bh + koff), ks > 0);
      Wgmma<NB>::run(part, ahi, tile_desc(bl + koff), 1);
      Wgmma<NB>::run(part, ahi, tile_desc(bh + koff), 1);
      wgmma_commit();
      wgmma_wait_all();
    }
#pragma unroll
    for (int q = 0; q < NB / 2; ++q) total[q] += part[q];
  }

  // Accumulator: for each 8-column group i, total[4 i + 2 h + e] is row
  // g + 8 h, column 8 i + 2 t + e.
  float* out = dst + (size_t)blockIdx.z * n * p;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = rows[h];
    if (r >= n) continue;
#pragma unroll
    for (int i = 0; i < NB / 8; ++i)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = c0 + 8 * i + 2 * t + e;
        if (c < p) out[(size_t)r * p + c] = total[4 * i + 2 * h + e];
      }
  }
}

template <int KIND, int D, int NB>
cudaError_t launch_mma(const float* x, const float* y, const float* vh, const float* vl,
                       float* dst, int n, int m, int d, int p, int span, int splits, float alpha,
                       cudaStream_t s) {
  constexpr int smem = mma_smem_floats<NB, (D > 0 ? D : 1)>() * (int)sizeof(float);
  auto kernel = gmv_mma_kernel<KIND, D, NB>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + kWgRows - 1) / kWgRows, (p + NB - 1) / NB, splits);
  kernel<<<grid, kWgThreads, smem, s>>>(x, y, vh, vl, dst, n, m, d, p, span, alpha);
  return cudaGetLastError();
}

template <int KIND, int D>
cudaError_t mma_by_width(int nb, const float* x, const float* y, const float* vh, const float* vl,
                         float* dst, int n, int m, int d, int p, int span, int splits, float alpha,
                         cudaStream_t s) {
  switch (nb) {
    case 24: return launch_mma<KIND, D, 24>(x, y, vh, vl, dst, n, m, d, p, span, splits, alpha, s);
    case 32: return launch_mma<KIND, D, 32>(x, y, vh, vl, dst, n, m, d, p, span, splits, alpha, s);
    case 64: return launch_mma<KIND, D, 64>(x, y, vh, vl, dst, n, m, d, p, span, splits, alpha, s);
    case 128: return launch_mma<KIND, D, 128>(x, y, vh, vl, dst, n, m, d, p, span, splits, alpha, s);
    default: return cudaErrorInvalidValue;
  }
}

template <int KIND>
cudaError_t mma_by_depth(int nb, const float* x, const float* y, const float* vh, const float* vl,
                         float* dst, int n, int m, int d, int p, int span, int splits, float alpha,
                         cudaStream_t s) {
  if (d == 1) return mma_by_width<KIND, 1>(nb, x, y, vh, vl, dst, n, m, d, p, span, splits, alpha, s);
  return mma_by_width<KIND, 0>(nb, x, y, vh, vl, dst, n, m, d, p, span, splits, alpha, s);
}

}  // namespace

// Launches the tensor-core K3 on `stream`: out (n, p) = G(x, y) @ v in
// float32. `kind` follows the Kind enum of gram_kind.cuh; `nb` (24, 32, 64
// or 128) is the output columns a block holds; the column sweep is split
// into `splits` ranges of `span` columns (a multiple of 64), and with
// splits > 1 `work` holds splits * n * p partial sums. `vsplit` holds
// 2 * ceil(m / 64) * ceil(p / nb) * 64 * nb floats: v's high and low
// parts in their shared-memory order, written here by gmv_split_v.
// Returns cudaGetLastError() after the launches; the caller raises if it
// is not 0.
extern "C" int stheno_gram_matvec_mma(int kind, const void* x_, const void* y_, const void* v_,
                                      void* out_, void* work_, void* vsplit_, int n, int m, int d,
                                      int p, int nb, int span, int splits, double alpha_,
                                      void* stream) {
  if (n <= 0 || m <= 0 || d <= 0 || p <= 0 || span <= 0 || span % kCols != 0 || splits <= 0 ||
      splits > 65535 || (long long)span * splits < m || (splits > 1 && work_ == nullptr) ||
      vsplit_ == nullptr)
    return (int)cudaErrorInvalidValue;
  const float* x = static_cast<const float*>(x_);
  const float* y = static_cast<const float*>(y_);
  const float* v = static_cast<const float*>(v_);
  float* out = static_cast<float*>(out_);
  float* work = static_cast<float*>(work_);
  float* dst = splits > 1 ? work : out;
  const float alpha = (float)alpha_;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int psplits = (p + nb - 1) / nb;
  const size_t count = (size_t)((m + kCols - 1) / kCols) * psplits * kCols * nb;
  float* vh = static_cast<float*>(vsplit_);
  float* vl = vh + count;
  gmv_split_v<<<(int)((count + 255) / 256 < 4096 ? (count + 255) / 256 : 4096), 256, 0, s>>>(
      v, vh, vl, m, p, nb, psplits, count);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  switch (kind) {
    case stheno::kEq: err = mma_by_depth<stheno::kEq>(nb, x, y, vh, vl, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kRq: err = mma_by_depth<stheno::kRq>(nb, x, y, vh, vl, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kMatern12: err = mma_by_depth<stheno::kMatern12>(nb, x, y, vh, vl, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kMatern32: err = mma_by_depth<stheno::kMatern32>(nb, x, y, vh, vl, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kMatern52: err = mma_by_depth<stheno::kMatern52>(nb, x, y, vh, vl, dst, n, m, d, p, span, splits, alpha, s); break;
    case stheno::kLinear: err = mma_by_depth<stheno::kLinear>(nb, x, y, vh, vl, dst, n, m, d, p, span, splits, alpha, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)reduce_splits<float>(work, out, (size_t)n * p, splits, s);
}
