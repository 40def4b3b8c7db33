// Shared pieces of the two raster kernels (raster_fused.cu, raster_accum.cu).
//
// Rounding is spelled out: every plane evaluation a*X + b*Y + c is
// fma(a, X, b*Y) + c with __fmaf_rn/__fmul_rn/__fadd_rn — the contraction
// XLA applies to the JAX reference on the CPU (measured) — and the library
// is built with -fmad=false, so nvcc contracts nothing else. The kernels
// then round exactly as the plain PyTorch versions (raster.fma) and the JAX
// reference do. The fill rule is the explicit (c > 0) | (c == 0 & top_left)
// form, which stays exact with fp32 subnormals (no -ftz).
#pragma once

#include <cuda_runtime.h>

namespace tr {

constexpr int TILE_H = 32;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;
constexpr int ROWS_PER_PASS = THREADS / TILE_W;       // 2 tile rows per pass
constexpr int PIX = TILE_H * TILE_W / THREADS;         // 16 pixels per thread
constexpr int ROW_COLS = 48;                           // fat-row width
// Binning constants of kernels/raster.py (CHUNK, GROUP, entry_shift): a bin
// entry is cid << ENTRY_SHIFT | gmask, one gmask bit per GROUP triangles.
constexpr int CHUNK = 32;
constexpr int GROUP = 8;
constexpr int N_GROUPS = CHUNK / GROUP;                // 4 gmask bits
constexpr int ENTRY_SHIFT = 4;
constexpr int GMASK_ALL = (1 << N_GROUPS) - 1;
static_assert(N_GROUPS <= 4, "ENTRY_SHIFT holds at most 4 gmask bits");

__device__ __forceinline__ float plane(float a, float b, float c, float x,
                                       float y) {
  return __fadd_rn(__fmaf_rn(a, x, __fmul_rn(b, y)), c);
}

__device__ __forceinline__ bool top_left(float a, float b) {
  return (a > 0.0f) || (a == 0.0f && b > 0.0f);
}

__device__ __forceinline__ bool edge_cov(float a, float b, float c, bool tl,
                                         float x, float y) {
  const float v = plane(a, b, c, x, y);
  return (v > 0.0f) || (v == 0.0f && tl);
}

// Coverage of triangle row r at pixel (x, y), with its depth in *zv.
struct Tri {
  float e[12];
  bool tl0, tl1, tl2;

  __device__ __forceinline__ void load(const float* r) {
#pragma unroll
    for (int k = 0; k < 12; ++k) e[k] = r[k];
    tl0 = top_left(e[0], e[1]);
    tl1 = top_left(e[3], e[4]);
    tl2 = top_left(e[6], e[7]);
  }

  __device__ __forceinline__ bool covers(float x, float y, float* zv) const {
    *zv = plane(e[9], e[10], e[11], x, y);
    return edge_cov(e[0], e[1], e[2], tl0, x, y) &&
           edge_cov(e[3], e[4], e[5], tl1, x, y) &&
           edge_cov(e[6], e[7], e[8], tl2, x, y) && (*zv <= 1.0f);
  }
};

// Cooperatively stage one chunk's fat rows in shared memory. The caller
// synchronises before (the previous chunk is consumed) and after.
__device__ __forceinline__ void stage_chunk(float* srow, const float* rows,
                                            int cid) {
  const float* src = rows + static_cast<size_t>(cid) * CHUNK * ROW_COLS;
  for (int k = threadIdx.x; k < CHUNK * ROW_COLS; k += THREADS) srow[k] = src[k];
}

}  // namespace tr
