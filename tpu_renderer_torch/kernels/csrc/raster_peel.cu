// Kernel 2.3: one textured-transparency peel over dense chunk bins.
//
// Replaces the Pallas kernel raster._peel_stream_loop of the JAX package
// (tpu_renderer/kernels/raster.py, launched as _peel_chunks_fresh_kernel /
// _peel_chunks_state_kernel through _peel_slab_call from
// rasterize_peel_slabs). Per pixel it finds the smallest triangle id greater
// than last[pixel] that covers the pixel (top-left fill rule, z <= 1) and
// passes the depth test z >= z_base[pixel] against the opaque depth: the
// next layer in submission order, the order the reference blends its
// transparent draws in (vk_engine.cpp:1459-1465). Per 32x128 tile the kernel
// walks the tile's bin entries (cid << ENTRY_SHIFT | gmask) in ascending
// chunk id and skips groups whose gmask bit is 0, keeping only best[pixel]
// in registers. After the walk each pixel with a layer reads that
// triangle's fat row once and writes its 4 numerator and 15 constant
// planes. The JAX kernel re-selects those planes after every group; within
// a walk only the first eligible id ever takes a pixel (ids ascend and the
// take needs id < best), so the final planes are that id's either way.
//
// What bounds it on the H100: per-pixel ALU work over bin entries (3 edge
// planes and the depth plane, ~16 float operations, per live triangle per
// pixel), not bytes: a chunk's 6 KB of rows serve 4096 pixels. As in
// raster_fused.cu the densest tile's serial walk sets the time.
// What the design does about it: one block per tile, 256 threads x 16
// pixels with best, last and the opaque depth in registers; the chunk's
// rows staged once in shared memory and read as broadcasts; dead groups
// skipped on the gmask bit; the planes read once per pixel after the walk.
// The walk ends early, exactly, once every pixel of the tile holds a layer:
// ids ascend along it, so no later triangle can take a pixel
// (__syncthreads_and, the barrier before staging each chunk).

#include "raster_common.cuh"

namespace {

using namespace tr;

__global__ void __launch_bounds__(THREADS)
raster_peel_fused_kernel(const float* __restrict__ rows, const int* __restrict__ bins,
                         const int* __restrict__ counts, int bin_width, int n_chunks,
                         int tiles_x, const float* __restrict__ z_base,
                         const int* __restrict__ last, int* __restrict__ best_out,
                         float* __restrict__ nums_out, float* __restrict__ metas_out,
                         int hp, int wp) {
  __shared__ float srow[CHUNK * ROW_COLS];
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

  // bins and counts come from the caller: never walk past the bin row
  // or read a chunk that is not there
  const int n = min(counts[tile], bin_width);
  const int* tbins = bins + static_cast<size_t>(tile) * bin_width;
  for (int e = 0; e < n; ++e) {
    const int entry = tbins[e];
    const int cid = entry >> ENTRY_SHIFT;
    const int gmask = entry & GMASK_ALL;
    if (cid < 0 || cid >= n_chunks) continue;  // uniform across the block
    int found = 1;
#pragma unroll
    for (int i = 0; i < PIX; ++i) found &= best[i] < ID_INF;
    if (__syncthreads_and(found)) break;   // every pixel holds its layer
    stage_chunk(srow, rows, cid);
    __syncthreads();
#pragma unroll 1
    for (int g = 0; g < N_GROUPS; ++g) {
      if (!((gmask >> g) & 1)) continue;
#pragma unroll 1
      for (int t = g * GROUP; t < (g + 1) * GROUP; ++t) {
        Tri tri;
        tri.load(srow + t * ROW_COLS);
        const int id = cid * CHUNK + t;
#pragma unroll
        for (int i = 0; i < PIX; ++i) {
          float zv;
          // zv >= 0 is subsumed by zv >= z_base (opaque depth, >= 0)
          if (id > lt[i] && id < best[i] && tri.covers(x, y[i], &zv) && zv >= zb[i])
            best[i] = id;
        }
      }
    }
  }

  const size_t plane_stride = static_cast<size_t>(hp) * wp;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const size_t p = static_cast<size_t>(pixel_row(ty, i)) * wp + tx * TILE_W + col;
    best_out[p] = best[i];
    store_winner(rows, best[i] < ID_INF ? best[i] : -1, x, y[i], p, plane_stride,
                 nums_out, metas_out);
  }
}

}  // namespace

extern "C" int raster_peel_fused_launch(const float* rows, const int* bins,
                                        const int* counts, int bin_width, int n_chunks,
                                        int tiles_x, int tiles_y, const float* z_base,
                                        const int* last, int* best, float* nums,
                                        float* metas, void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  raster_peel_fused_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, bins, counts, bin_width, n_chunks, tiles_x, z_base, last, best, nums, metas,
      tiles_y * TILE_H, tiles_x * TILE_W);
  return static_cast<int>(cudaGetLastError());
}
