// Kernel A: the opaque fused raster.
//
// Replaces the Pallas kernel raster._chunks_stream_loop of the JAX package
// (tpu_renderer/kernels/raster.py, launched as _raster_chunks_fresh_kernel /
// _raster_chunks_state_kernel from rasterize_fused_slabs). Per 32x128 tile it
// walks the tile's bin entries (cid << ENTRY_SHIFT | gmask) in ascending chunk id;
// for each group whose gmask bit is set it tests every triangle's 3 edge
// planes (top-left fill rule) and depth plane at each pixel center, keeping
// z and tid with reversed-Z `>=` and later-wins on ties. After the walk each
// covered pixel reads its winner's fat row once and writes the 4 numerator
// planes and the 15 constant planes (the JAX kernel re-selects them per
// chunk; the final planes are the last winner's either way).
//
// What bounds it on the H100: per-pixel ALU work over bin entries — 4
// planes (~16 float operations) per triangle per pixel, against 6 KB of
// fat rows read once per entry; not bytes. Blocks are independent and each
// walks its own tile serially, so the kernel lasts as long as its densest
// tile: on the bench frame 589 live groups in the busiest tile against a
// mean of 15.5 (75k triangle-pixel tests per thread), while the ALU work
// of all tiles together would take 0.06 ms at the fp32 peak.
// What the design does about it: one thread block per tile, 256 threads
// owning 16 pixels each in registers (z, tid and the pixel rows never leave
// registers during the walk); a chunk's rows are staged once in shared
// memory and read as broadcasts; dead groups are skipped on the gmask bit,
// so their triangles cost no ALU at all; the attribute planes are evaluated
// once per pixel instead of once per winning chunk. Splitting a dense
// tile's entries over several blocks (the winner is the lexicographic max
// of (z, tid), so partial results merge exactly) is left for later.

#include "raster_common.cuh"

namespace {

using namespace tr;

__global__ void __launch_bounds__(THREADS)
raster_fused_kernel(const float* __restrict__ rows, const int* __restrict__ bins,
                    const int* __restrict__ counts, int bin_width, int n_chunks,
                    int tiles_x, float* __restrict__ z_out,
                    int* __restrict__ tid_out, float* __restrict__ nums_out,
                    float* __restrict__ metas_out, int hp, int wp) {
  __shared__ float srow[CHUNK * ROW_COLS];
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int col = threadIdx.x % TILE_W;
  const int row0 = threadIdx.x / TILE_W;
  const float x = static_cast<float>(tx * TILE_W + col) + 0.5f;

  float y[PIX], z[PIX];
  int tid[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    y[i] = static_cast<float>(ty * TILE_H + row0 + i * ROWS_PER_PASS) + 0.5f;
    z[i] = 0.0f;  // DEPTH_CLEAR
    tid[i] = -1;
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
    __syncthreads();
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
          // zv >= 0 is subsumed by zv >= z (z starts at 0)
          if (tri.covers(x, y[i], &zv) && zv >= z[i]) {
            z[i] = zv;
            tid[i] = id;
          }
        }
      }
    }
  }

  const size_t plane_stride = static_cast<size_t>(hp) * wp;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const size_t p = static_cast<size_t>(pixel_row(ty, i)) * wp + tx * TILE_W + col;
    z_out[p] = z[i];
    tid_out[p] = tid[i];
    store_winner(rows, tid[i], x, y[i], p, plane_stride, nums_out, metas_out);
  }
}

}  // namespace

extern "C" int raster_fused_launch(const float* rows, const int* bins,
                                   const int* counts, int bin_width, int n_chunks,
                                   int tiles_x, int tiles_y,
                                   float* z, int* tid, float* nums, float* metas,
                                   void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  raster_fused_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, bins, counts, bin_width, n_chunks, tiles_x, z, tid, nums, metas,
      tiles_y * TILE_H, tiles_x * TILE_W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* raster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
