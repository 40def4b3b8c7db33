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
// per batch of 256 entries (2.5: 512) every thread loads one entry's 12 plane
// coefficients into shared memory, then all threads walk the batch.
//
// What bounds it on the H100: per-pixel ALU work, the 4 planes (~16 float
// operations) of every binned triangle at every pixel of its tile; the
// table reads are 48 B per entry against 4096 pixel tests. The densest
// tile's serial walk sets the time: on the deferred frame one tile holds
// 4,453 entries (2.4) and 561 (2.5's bins), against means of 102 and 11.
// What the design of 2.4 does about it: one block per 32x128 tile, 256
// threads x 16 pixels with the per-pixel state in registers; the batch's
// coefficients in shared memory, read as broadcasts; entries that are
// padding or past the table are dropped at the load, uniformly.
// 2.5 is kernel 2.3's design (raster_peel.cu): a cluster of PEEL_SPLIT
// blocks a tile, each walking a segment of the entries with the per-region
// and per-row reject and the exact stops, merged by a min (see below); on
// the deferred frame's first peel (H100 80GB HBM3, 700 W) 0.08-0.09 ms, of
// which 0.05-0.07 is the launch of the 4,080 blocks with no entries.

#include "raster_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tr;

constexpr int BATCH = THREADS;  // bin entries staged per pass
constexpr int PLANE_COLS = 12;  // edge + depth coefficients of a packed row
constexpr int SETUP_COLS = 16;  // packed setup-row width

// Stage entries [base, base + blockDim.x) of a tile's bin, one a thread:
// ids (-1 where the entry is at or past n or not a triangle of the table)
// and their plane coefficients, STRIDE floats apart. The caller
// synchronises before and after.
template <int STRIDE>
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
    for (int c = 0; c < PLANE_COLS; ++c) scoef[threadIdx.x * STRIDE + c] = r[c];
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
    stage_batch<PLANE_COLS>(scoef, sid, packed, n_tris, tbins, base, n);
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

// Kernel 2.5: kernel 2.3's design (raster_peel.cu) over per-triangle bins.
// A segment covers one per DEFERRED_SEG_MIN entries, at most PEEL_SPLIT, a
// block of the tile's cluster each. Each block stages its segment's entries
// DEFERRED_BATCH at a time (id and 12 plane coefficients a thread); lane t
// of each warp tests entry t of a 32-entry slice against its warp's region
// (cover_rows reads only columns 0-8, as a packed row has them), and the
// warp walks the entries its ballot keeps, on the rows they may cover. The
// stops are 2.3's, on the ids themselves; the merge is the same min, and a
// tile of one segment is again block 0's alone.
constexpr int DEFERRED_SEG_MIN = 32;            // a segment for every 32 entries
constexpr int DEFERRED_BATCH = PEEL_THREADS;    // entries staged per pass, one a thread
constexpr int COEF_STRIDE = PLANE_COLS + 1;     // lane t's row t: 32 distinct banks
static_assert(TILE_PIX <= DEFERRED_BATCH * COEF_STRIDE, "the merge buffer fits the batch");

__global__ void __cluster_dims__(PEEL_SPLIT, 1, 1) __launch_bounds__(PEEL_THREADS, 2)
raster_peel_deferred_kernel(const float* __restrict__ packed, int n_tris,
                            const int* __restrict__ bins, const int* __restrict__ counts,
                            int bin_width, int tiles_x, const float* __restrict__ z_base,
                            const int* __restrict__ last, int* __restrict__ layer_out,
                            int wp) {
  // the batch's plane coefficients, then the segment's layer ids for the merge
  __shared__ float scoef[DEFERRED_BATCH * COEF_STRIDE];
  __shared__ int sid[DEFERRED_BATCH];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / PEEL_SPLIT;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rx0 = (warp % (TILE_W / REGION_W)) * REGION_W;   // region in the tile
  const int ry0 = (warp / (TILE_W / REGION_W)) * REGION_H;
  const Region region(tx * TILE_W + rx0, ty * TILE_H + ry0);
  const int n = max(0, min(counts[tile], bin_width));
  int e0, e1;
  const int segs = peel_segment(n, DEFERRED_SEG_MIN, rank, &e0, &e1);
  // a tile of one segment is block 0's alone: no merge, no cluster barrier
  if (segs == 1 && rank > 0) return;

  PeelPixels<true> s;
  if (rank < segs) {   // uniform across the block
    s.load(z_base, last, tx * TILE_W + rx0 + lane, ty * TILE_H + ry0, wp, n_tris - 1);
    const int* tbins = bins + static_cast<size_t>(tile) * bin_width;
    s.ascending = keys_ascend(tbins, e0, e1, 0);
    for (int base = e0; base < e1; base += DEFERRED_BATCH) {
      // the barrier before restaging: the previous batch is consumed
      if (__syncthreads_and(s.settled())) break;   // every pixel of the block is settled
      stage_batch<COEF_STRIDE>(scoef, sid, packed, n_tris, tbins, base, e1);
      __syncthreads();
      const int m = min(DEFERRED_BATCH, e1 - base);
      for (int j0 = 0; j0 < m; j0 += 32) {
        if (__all_sync(FULL_WARP, s.settled())) break;   // uniform across the warp
        const int j = j0 + lane;
        const int idj = j < m ? sid[j] : -1;
        const unsigned rows_of =
            idj >= 0 && idj > s.lt_min ? cover_rows(scoef + j * COEF_STRIDE, region) : 0u;
        unsigned b = __ballot_sync(FULL_WARP, rows_of != 0);
        while (b) {
          const int t = __ffs(b) - 1;
          b &= b - 1;
          Tri tri;
          tri.load(scoef + (j0 + t) * COEF_STRIDE);
          s.take(tri, sid[j0 + t], __shfl_sync(FULL_WARP, rows_of, t));
        }
      }
    }
  }
  if (segs == 1) {
#pragma unroll
    for (int i = 0; i < REGION_H; ++i)
      layer_out[static_cast<size_t>(ty * TILE_H + ry0 + i) * wp + tx * TILE_W + rx0 + lane] =
          s.best[i];
    return;
  }
  __syncthreads();   // the batch buffer is free for the merge

  const int best = merge_min(cluster, reinterpret_cast<int*>(scoef), s, rx0, ry0, rank, segs);
  const int p = rank * PEEL_THREADS + threadIdx.x;
  layer_out[static_cast<size_t>(ty * TILE_H + p / TILE_W) * wp + tx * TILE_W + p % TILE_W] = best;
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
  raster_peel_deferred_kernel<<<n_tiles * PEEL_SPLIT, PEEL_THREADS, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      packed, n_tris, bins, counts, bin_width, tiles_x, z_base, last, layer,
      tiles_x * TILE_W);
  return static_cast<int>(cudaGetLastError());
}
