// Kernels 2.4 and 2.5: the deferred path's visibility raster and peel over
// capped per-triangle bins.
//
// 2.4 replaces the Pallas kernel raster._raster_kernel of the JAX package
// (tpu_renderer/kernels/raster.py, from rasterize): per pixel the reversed-Z
// (>=) winner among the tile's binned triangles, later bin entries winning
// ties, with 0 <= z <= 1; out come z and the triangle id (-1: none).
// 2.5 replaces raster._peel_kernel (from rasterize_peel): per pixel the
// smallest binned triangle id greater than last[pixel] that covers it with
// 0 <= z <= 1 and z >= z_base[pixel]; out comes that id (ID_INF: none).
//
// A bin entry is a triangle id into the (T, 16) packed setup table
// (vertex.triangle_setup_c): 3 edge planes, the depth plane, validity and
// material. The JAX wrappers gather each tile's rows into a
// (n_tiles, cap, 16) block first; at an escalated cap of 16384 that block
// is 535 MB. Here each block reads the rows by id straight from the table:
// per batch of 256 entries every thread loads one entry's 12 plane
// coefficients into shared memory, then all threads walk the batch.
//
// What bounds it on the H100: per-pixel ALU work, the 4 planes (~16 float
// operations) of every binned triangle at every pixel of its tile; the
// table reads are 48 B per entry against 4096 pixel tests. As in the fused
// kernels the densest tile's serial walk sets the time.
// What the design does about it: one block per 32x128 tile, 256 threads x
// 16 pixels with the per-pixel state in registers; the batch's coefficients
// in shared memory, read as broadcasts; entries that are padding or past
// the table are dropped at the load, uniformly. The peel ends its walk
// exactly once every pixel of the tile holds a layer (the ids ascend).

#include "raster_common.cuh"

namespace {

using namespace tr;

constexpr int BATCH = THREADS;  // bin entries staged per pass
constexpr int PLANE_COLS = 12;  // edge + depth coefficients of a packed row
constexpr int SETUP_COLS = 16;  // packed setup-row width

// Stage entries [base, base + BATCH) of a tile's bin: ids (-1 where the
// entry is past the count or not a triangle of the table) and their plane
// coefficients. The caller synchronises before and after.
__device__ __forceinline__ void stage_batch(float* scoef, int* sid,
                                            const float* __restrict__ packed,
                                            int n_tris, const int* tbins, int base,
                                            int n) {
  const int k = base + static_cast<int>(threadIdx.x);
  int id = k < n ? tbins[k] : -1;
  if (id >= n_tris) id = -1;
  sid[threadIdx.x] = id < 0 ? -1 : id;
  if (id >= 0) {
    const float* r = packed + static_cast<size_t>(id) * SETUP_COLS;
#pragma unroll
    for (int c = 0; c < PLANE_COLS; ++c) scoef[threadIdx.x * PLANE_COLS + c] = r[c];
  }
}

__global__ void __launch_bounds__(THREADS)
raster_deferred_kernel(const float* __restrict__ packed, int n_tris,
                       const int* __restrict__ bins, const int* __restrict__ counts,
                       int bin_width, int tiles_x, float* __restrict__ z_out,
                       int* __restrict__ tid_out, int wp) {
  __shared__ float scoef[BATCH * PLANE_COLS];
  __shared__ int sid[BATCH];
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int col = threadIdx.x % TILE_W;
  const float x = static_cast<float>(tx * TILE_W + col) + 0.5f;

  float y[PIX], z[PIX];
  int tid[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    y[i] = static_cast<float>(pixel_row(ty, i)) + 0.5f;
    z[i] = 0.0f;  // DEPTH_CLEAR
    tid[i] = -1;
  }

  const int n = min(counts[tile], bin_width);
  const int* tbins = bins + static_cast<size_t>(tile) * bin_width;
  for (int base = 0; base < n; base += BATCH) {
    __syncthreads();
    stage_batch(scoef, sid, packed, n_tris, tbins, base, n);
    __syncthreads();
    const int m = min(BATCH, n - base);
#pragma unroll 1
    for (int j = 0; j < m; ++j) {
      const int id = sid[j];
      if (id < 0) continue;  // uniform across the block
      Tri tri;
      tri.load(scoef + j * PLANE_COLS);
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        float zv;
        if (tri.covers(x, y[i], &zv) && zv >= 0.0f && zv >= z[i]) {
          z[i] = zv;
          tid[i] = id;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const size_t p = static_cast<size_t>(pixel_row(ty, i)) * wp + tx * TILE_W + col;
    z_out[p] = z[i];
    tid_out[p] = tid[i];
  }
}

__global__ void __launch_bounds__(THREADS)
raster_peel_deferred_kernel(const float* __restrict__ packed, int n_tris,
                            const int* __restrict__ bins, const int* __restrict__ counts,
                            int bin_width, int tiles_x, const float* __restrict__ z_base,
                            const int* __restrict__ last, int* __restrict__ layer_out,
                            int wp) {
  __shared__ float scoef[BATCH * PLANE_COLS];
  __shared__ int sid[BATCH];
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int col = threadIdx.x % TILE_W;
  const float x = static_cast<float>(tx * TILE_W + col) + 0.5f;

  float y[PIX], zb[PIX];
  int lt[PIX], best[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const size_t p = static_cast<size_t>(pixel_row(ty, i)) * wp + tx * TILE_W + col;
    y[i] = static_cast<float>(pixel_row(ty, i)) + 0.5f;
    zb[i] = z_base[p];
    lt[i] = last[p];
    best[i] = ID_INF;
  }

  const int n = min(counts[tile], bin_width);
  const int* tbins = bins + static_cast<size_t>(tile) * bin_width;
  for (int base = 0; base < n; base += BATCH) {
    int found = 1;
#pragma unroll
    for (int i = 0; i < PIX; ++i) found &= best[i] < ID_INF;
    if (__syncthreads_and(found)) break;   // every pixel holds its layer
    stage_batch(scoef, sid, packed, n_tris, tbins, base, n);
    __syncthreads();
    const int m = min(BATCH, n - base);
#pragma unroll 1
    for (int j = 0; j < m; ++j) {
      const int id = sid[j];
      if (id < 0) continue;  // uniform across the block
      Tri tri;
      tri.load(scoef + j * PLANE_COLS);
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        float zv;
        if (id > lt[i] && id < best[i] && tri.covers(x, y[i], &zv) && zv >= 0.0f &&
            zv >= zb[i])
          best[i] = id;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const size_t p = static_cast<size_t>(pixel_row(ty, i)) * wp + tx * TILE_W + col;
    layer_out[p] = best[i];
  }
}

}  // namespace

extern "C" int raster_deferred_launch(const float* packed, int n_tris, const int* bins,
                                      const int* counts, int bin_width, int tiles_x,
                                      int tiles_y, float* z, int* tid, void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  raster_deferred_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, n_tris, bins, counts, bin_width, tiles_x, z, tid, tiles_x * TILE_W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int raster_peel_deferred_launch(const float* packed, int n_tris,
                                           const int* bins, const int* counts,
                                           int bin_width, int tiles_x, int tiles_y,
                                           const float* z_base, const int* last,
                                           int* layer, void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  raster_peel_deferred_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, n_tris, bins, counts, bin_width, tiles_x, z_base, last, layer,
      tiles_x * TILE_W);
  return static_cast<int>(cudaGetLastError());
}
