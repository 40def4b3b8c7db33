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
// is 535 MB. Here each block reads the rows by id straight from the table,
// a batch of one entry a thread at a time (512 at 32x128 tiles), one
// entry's 12 plane coefficients a thread, into shared memory.
//
// What bounds them on the H100: per-pixel ALU work, the 4 planes (~16
// float operations) of a binned triangle at a pixel, against 48 B of table
// read an entry; and, unless the work is spread, the densest tile: on the
// deferred frame one tile holds 4,453 entries (2.4; 561 in 2.5's first
// peel) against a mean of 102 (11), and most of a dense tile's triangles
// cover a few pixels of one 32x8 region. One block a tile testing every
// entry at every pixel (2.4 before this design) took 4.8-4.9 ms on an H100
// 80GB HBM3 at 700 W, 1% of its bound.
// What the design does about it (2.4 shares it with 2.6, vis_tile in
// raster_common.cuh; 2.5 is 2.3's, raster_peel.cu, and shares its walk
// with 2.8, peel_tile in raster_common.cuh):
// * a cluster of blocks a tile, each walking a contiguous segment of the
//   entries, one segment for every SEG_MIN entries; a tile of one segment
//   is its first block's alone, with no merge and no cluster barrier;
// * each warp owns a 32x8 region, one column a lane: lane t tests entry t
//   of a 32-entry slice against the region's rows (cover_rows, exact with
//   its rounding margin), and the warp walks only what its ballot keeps,
//   on the rows each entry may cover;
// * 2.4 folds the segments' (z, tid) in segment order with the walk's own
//   rule (exact for bins in any order), 2.5 merges its segments' layers by
//   a min; both through distributed shared memory, in one launch. 2.5's
//   walk stops early only where its segment's ids strictly ascend
//   (keys_ascend; a -1 hole after a live id reads as not ascending, which
//   costs the stop and never the result).
// On the deferred frame (H100 80GB HBM3, 700 W) 2.4 takes 0.21-0.23 ms:
// 0.04-0.05 with no entries (the launch of 4,080 clusters), ~0.12 the
// densest tiles' segments of ~557 entries. A cluster of 16 (non-portable;
// launch_vis allows it from the constant alone) halved those segments and
// was slower: its 65,280 blocks cost more than the tail it cut.

#include "raster_common.cuh"

namespace {

using namespace tr;

constexpr int SETUP_COLS = 16;  // packed setup-row width

// Kernel 2.4 (vis_tile in raster_common.cuh): z and tid for the block's
// pixels.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 2)
raster_deferred_kernel(const float* __restrict__ packed, int n_tris,
                       const int* __restrict__ bins, const int* __restrict__ counts,
                       int bin_width, int tiles_x, int tile_y0, float* __restrict__ z_out,
                       int* __restrict__ tid_out, int wp) {
  const Band band{tile_y0 * T::H, wp};
  vis_tile<T, SETUP_COLS>(packed, n_tris, bins, counts, bin_width, tiles_x, band,
                       [&](int row, int col, float z, int tid) {
                         const size_t gp = band.at(row, col);
                         z_out[gp] = z;
                         tid_out[gp] = tid;
                       });
}

// Kernel 2.5: peel_tile (raster_common.cuh, kernel 2.8's walk too) over the
// packed setup rows; out comes the layer id.
template <class T>
__global__ void __cluster_dims__(PEEL_SPLIT, 1, 1) __launch_bounds__(T::THREADS, 2)
raster_peel_deferred_kernel(const float* __restrict__ packed, int n_tris,
                            const int* __restrict__ bins, const int* __restrict__ counts,
                            int bin_width, int tiles_x, int tile_y0,
                            const float* __restrict__ z_base, const int* __restrict__ last,
                            int* __restrict__ layer_out, int wp) {
  const Band band{tile_y0 * T::H, wp};
  peel_tile<T, SETUP_COLS>(packed, n_tris, bins, counts, bin_width, tiles_x, z_base, last, band,
                        [&](int row, int col, int best) {
                          layer_out[band.at(row, col)] = best;
                        });
}

// Kernels 2.4 and 2.5 at a tile of several passes (Tile): vis_tile_passes
// and peel_tile_passes, in dynamic shared memory.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 2)
raster_deferred_passes_kernel(const float* __restrict__ packed, int n_tris,
                              const int* __restrict__ bins, const int* __restrict__ counts,
                              int bin_width, int tiles_x, int tile_y0,
                              float* __restrict__ z_out, int* __restrict__ tid_out, int wp) {
  const Band band{tile_y0 * T::H, wp};
  vis_tile_passes<T, SETUP_COLS>(packed, n_tris, bins, counts, bin_width, tiles_x, band,
                                 [&](int row, int col, float z, int tid) {
                                   const size_t gp = band.at(row, col);
                                   z_out[gp] = z;
                                   tid_out[gp] = tid;
                                 });
}

template <class T>
__global__ void __cluster_dims__(PEEL_SPLIT, 1, 1) __launch_bounds__(T::THREADS, 2)
raster_peel_deferred_passes_kernel(const float* __restrict__ packed, int n_tris,
                                   const int* __restrict__ bins, const int* __restrict__ counts,
                                   int bin_width, int tiles_x, int tile_y0,
                                   const float* __restrict__ z_base,
                                   const int* __restrict__ last, int* __restrict__ layer_out,
                                   int wp) {
  const Band band{tile_y0 * T::H, wp};
  peel_tile_passes<T, SETUP_COLS>(packed, n_tris, bins, counts, bin_width, tiles_x, z_base,
                                  last, band, [&](int row, int col, int best) {
                                    layer_out[band.at(row, col)] = best;
                                  });
}

// Kernels 2.4's and 2.5's *_passes instances set up for this device
// (prepare_launch).
template <class T>
int deferred_prepare() {
  static Prepared ready;
  return prepare_launch(ready, raster_deferred_passes_kernel<T>, T::THREADS, VisSmem<T>::BYTES,
                        VIS_SPLIT, 4);
}

template <class T>
int peel_deferred_prepare() {
  static Prepared ready;
  return prepare_launch(ready, raster_peel_deferred_passes_kernel<T>, T::THREADS,
                        PeelSmem<T>::BYTES, PEEL_SPLIT, 5);
}

}  // namespace

// Kernels 2.4 and 2.5 at the tile, as raster_fused_setup does 2.1.
extern "C" int raster_deferred_setup(int tile_h, int tile_w, int* bytes) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    if constexpr (T::PASSES == 1) {
      return block_smem(raster_deferred_kernel<T>, 0, bytes);
    } else {
      const int err = block_smem(raster_deferred_passes_kernel<T>, VisSmem<T>::BYTES, bytes);
      return err != 0 ? err : deferred_prepare<T>();
    }
  });
}

extern "C" int raster_peel_deferred_setup(int tile_h, int tile_w, int* bytes) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    if constexpr (T::PASSES == 1) {
      return block_smem(raster_peel_deferred_kernel<T>, 0, bytes);
    } else {
      const int err =
          block_smem(raster_peel_deferred_passes_kernel<T>, PeelSmem<T>::BYTES, bytes);
      return err != 0 ? err : peel_deferred_prepare<T>();
    }
  });
}

extern "C" int raster_deferred_launch(const float* packed, int n_tris, const int* bins,
                                      const int* counts, int bin_width, int tiles_x,
                                      int tiles_y, int tile_h, int tile_w, int tile_y0,
                                      float* z, int* tid, void* stream) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    if constexpr (T::PASSES == 1) {
      return launch_vis<T>(raster_deferred_kernel<T>, tiles_x * tiles_y, 0, stream, packed,
                           n_tris, bins, counts, bin_width, tiles_x, tile_y0, z, tid,
                           tiles_x * T::W);
    } else {
      constexpr int bytes = VisSmem<T>::BYTES;
      const int err = deferred_prepare<T>();
      if (err != 0) return err;
      return launch_vis<T>(raster_deferred_passes_kernel<T>, tiles_x * tiles_y, bytes, stream,
                           packed, n_tris, bins, counts, bin_width, tiles_x, tile_y0, z, tid,
                           tiles_x * T::W);
    }
  });
}

extern "C" int raster_peel_deferred_launch(const float* packed, int n_tris,
                                           const int* bins, const int* counts,
                                           int bin_width, int tiles_x, int tiles_y,
                                           int tile_h, int tile_w, int tile_y0,
                                           const float* z_base, const int* last, int* layer,
                                           void* stream) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    if constexpr (T::PASSES == 1) {
      raster_peel_deferred_kernel<T><<<tiles_x * tiles_y * PEEL_SPLIT, T::THREADS, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
          packed, n_tris, bins, counts, bin_width, tiles_x, tile_y0, z_base, last, layer,
          tiles_x * T::W);
    } else {
      constexpr int bytes = PeelSmem<T>::BYTES;
      const int err = peel_deferred_prepare<T>();
      if (err != 0) return err;
      raster_peel_deferred_passes_kernel<T><<<tiles_x * tiles_y * PEEL_SPLIT, T::THREADS,
                                              bytes, static_cast<cudaStream_t>(stream)>>>(
          packed, n_tris, bins, counts, bin_width, tiles_x, tile_y0, z_base, last, layer,
          tiles_x * T::W);
    }
    return static_cast<int>(cudaGetLastError());
  });
}
