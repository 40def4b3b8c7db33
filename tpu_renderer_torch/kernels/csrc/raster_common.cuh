// Shared pieces of the raster kernels (raster_fused.cu, raster_accum.cu,
// raster_peel.cu, raster_deferred.cu).
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
constexpr int ID_INF = 0x7FFFFFF;   // the peels' "no fragment" marker
constexpr int N_NUMS = 4;           // numerator planes: light_num, r, g, b
constexpr int N_METAS = 15;         // constant planes (META_COLS)

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

// META_COLS of kernels/raster.py: C_TEX x6 (31-36), C_GRAD x6 (37-42),
// den_c (43), nu_c (29), nv_c (30).
__device__ __forceinline__ int meta_col(int m) { return m < 13 ? 31 + m : 16 + m; }

// Pixel i of this thread in a tile: its row and its offset in a plane.
__device__ __forceinline__ int pixel_row(int ty, int i) {
  return ty * TILE_H + static_cast<int>(threadIdx.x) / TILE_W + i * ROWS_PER_PASS;
}

// The epilogue of the fused raster and the fused peel: the winning
// triangle's numerator planes at the pixel center and its constant planes,
// read once from its fat row; zeros where no triangle won (id < 0).
__device__ __forceinline__ void store_winner(const float* __restrict__ rows, int id,
                                             float x, float y, size_t p,
                                             size_t plane_stride,
                                             float* __restrict__ nums_out,
                                             float* __restrict__ metas_out) {
  if (id >= 0) {
    const float* w = rows + static_cast<size_t>(id) * ROW_COLS;
#pragma unroll
    for (int a = 0; a < N_NUMS; ++a)
      nums_out[a * plane_stride + p] = plane(w[13 + a], w[19 + a], w[25 + a], x, y);
#pragma unroll
    for (int m = 0; m < N_METAS; ++m) metas_out[m * plane_stride + p] = w[meta_col(m)];
  } else {
#pragma unroll
    for (int a = 0; a < N_NUMS; ++a) nums_out[a * plane_stride + p] = 0.0f;
#pragma unroll
    for (int m = 0; m < N_METAS; ++m) metas_out[m * plane_stride + p] = 0.0f;
  }
}

// One taken fragment of the untextured transparent sum (kernels 2.2 and
// 2.7): acc += rgb * (max(light, 0.1) * power + ambient) (mesh.frag:12-18),
// with the reference's two contractions. num holds the 4 numerator planes
// [light, r, g, b]: plane a's (A, B, C) at num[a], num[stride + a],
// num[2 * stride + a]; den the denominator's (A, B, C). Nothing is carried
// between fragments but the sums.
__device__ __forceinline__ void add_fragment(const float* num, int stride,
                                             const float* den3, float x, float y,
                                             float power, const float* amb, float* ar,
                                             float* ag, float* ab) {
  const float den = plane(den3[0], den3[1], den3[2], x, y);
  const float inv = den != 0.0f ? __fdiv_rn(1.0f, den) : 0.0f;
  const float ln = __fmul_rn(plane(num[0], num[stride], num[2 * stride], x, y), inv);
  // jnp.maximum / torch.maximum propagate NaN; fmaxf would not
  const float lit = ln != ln ? ln : fmaxf(ln, 0.1f);
  const float cr = __fmul_rn(plane(num[1], num[stride + 1], num[2 * stride + 1], x, y), inv);
  const float cg = __fmul_rn(plane(num[2], num[stride + 2], num[2 * stride + 2], x, y), inv);
  const float cb = __fmul_rn(plane(num[3], num[stride + 3], num[2 * stride + 3], x, y), inv);
  *ar = __fmaf_rn(cr, __fmaf_rn(lit, power, amb[0]), *ar);
  *ag = __fmaf_rn(cg, __fmaf_rn(lit, power, amb[1]), *ag);
  *ab = __fmaf_rn(cb, __fmaf_rn(lit, power, amb[2]), *ab);
}

}  // namespace tr
