// Kernels 2.6, 2.7 and 2.8: the gathered-row raster oracles. Each computes
// what one of the stream kernels computes (2.1 raster_fused.cu, 2.2
// raster_accum.cu, 2.3 raster_peel.cu), but over another bin format: a
// tile's bin holds TRIANGLE ids into the (T, 48) fat-row table, one entry a
// triangle, walked in slot order, instead of chunk entries with a group
// mask. The frame paths do not run them; the raster profile tool times 2.6,
// and the cross-checks hold each stream kernel to its oracle bit for bit.
//
// 2.6 replaces the Pallas kernel raster._raster_fused_kernel of the JAX
// package (tpu_renderer/kernels/raster.py, from rasterize_fused): per pixel
// the reversed-Z (>=) winner among the tile's binned triangles with
// 0 <= z <= 1, a later SLOT winning an equal z (the bins need not ascend);
// out come z, the winner's id (the bin entry itself; -1: none) and, read
// once after the walk, the winner's 4 numerator planes and 15 constant
// planes.
// 2.7 replaces raster._accum_fused_kernel (from rasterize_accum_fused):
// every covered fragment with 0 <= z <= 1 and z >= z_base adds its shaded
// colour and counts, in slot order (float addition does not commute).
// 2.8 replaces raster._peel_fused_kernel (from rasterize_peel_fused): per
// pixel the smallest binned id greater than last[pixel] that covers it with
// 0 <= z <= 1 and z >= z_base, and that triangle's planes (ID_INF: none).
// The rule is a min over the slots, so it needs no order of them.
//
// The JAX wrappers gather fat_rows[bins] into an (n_tiles, cap, 48) block
// first (802 MB at the deferred bench caps). Here a block reads rows by id
// from the table: 2.6 and 2.8 stage only the 12 edge and depth
// coefficients every pixel test reads (stage_planes, an entry a thread a
// batch), and read the winner's other columns once a pixel after the walk
// (store_winner), which equals the JAX kernels' select-at-take because the
// planes are a pure function of (row, pixel); 2.7 gathers each entry's
// whole fat row (12 pieces of 16 B), since a taken fragment reads its
// numerator and denominator planes too.
//
// The JAX kernels carry the id as a float in column 47 (exact below 2^24);
// the wrappers refuse a table of 2^24 rows or more. Entries past the
// tile's count are never read; an entry inside it that is no row of the
// table (negative, such as the -1 holes expand_bins leaves, or >= T) is
// dropped, uniformly, where the JAX wrapper would clip it onto row 0 or
// T-1: the contract is counts <= bin width and live entries in [0, T).
//
// What bounds them on the H100: per-pixel ALU work, the 4 planes (~16 float
// operations) of a binned triangle at a pixel, plus for 2.7 five planes and
// a divide a fragment taken, against 48 B (192 B for 2.7) of table an
// entry; and, unless the work is spread, the densest tile: on the deferred
// frame's bins one tile holds 4,453 entries against a mean of 102, on 2.8's
// first peel 1,056 against 55, on 2.7's 768 against 25. One block a tile
// testing every entry at every pixel (each kernel's first design) took 4.9
// ms (2.6), 1.19-1.21 (2.7) and 1.48-1.54 (2.8) on an H100 80GB HBM3 at
// 700 W, 1-4% of their bounds.
// What the designs do about it, each another kernel's, shared in
// raster_common.cuh so the two cannot drift apart:
// * 2.6 is kernel 2.4's (vis_tile): a cluster of VIS_SPLIT blocks a tile
//   over contiguous segments of the entries, each warp walking only the
//   entries and rows its 32x8 region may be covered by, the segments'
//   (z, tid) folded in segment order through distributed shared memory;
//   then each block runs store_winner for its 1/VIS_SPLIT of the tile's
//   pixels: 0.26-0.30 ms on the deferred frame's bins.
// * 2.8 is kernel 2.5's (peel_tile): a cluster of PEEL_SPLIT blocks a tile
//   over segments of the entries, the same reject and the warp's smallest
//   `last`, an early stop exact only where a segment's ids ascend, the
//   segments' layers merged by a min; then 2.3's epilogue (store_layer):
//   0.16-0.17 ms a first peel, of which 0.12-0.16 is its floor with no
//   entries (the launch of the clusters and the 20 output planes).
// * 2.7 is kernel 2.2's split of the pixels, finer: a block of one warp
//   for each 32x8 region of a tile (16 a tile; 2.2's 4 strips of 4 warps
//   measured 0.215-0.229 ms against 0.198-0.202), each walking the whole
//   list in slot order, 32 entries a slice, their fat rows gathered by id
//   into the cp.async ring (stage_slice_async, two slices ahead), and
//   2.2's per-chunk body on each slice (AccumPixels): ~0.20 ms, the
//   densest tiles' 24 slices most of it.
// The arithmetic is the stream kernels' own (raster_common.cuh), which is
// what makes the oracles exact.

#include "raster_common.cuh"

namespace {

using namespace tr;

// Kernel 2.6: kernel 2.4's walk and fold (vis_tile in raster_common.cuh)
// over the fat rows' first 12 columns, then the winner's planes for the
// block's pixels (store_winner, as 2.1's epilogue).
template <class T>
__global__ void __launch_bounds__(T::THREADS, 2)
raster_fused_gathered_kernel(const float* __restrict__ rows, int n_tris,
                             const int* __restrict__ bins, const int* __restrict__ counts,
                             int bin_width, int tiles_x, float* __restrict__ z_out,
                             int* __restrict__ tid_out, float* __restrict__ nums_out,
                             float* __restrict__ metas_out, int hp, int wp) {
  const size_t plane_stride = static_cast<size_t>(hp) * wp;
  const Band band{0, wp};   // the whole frame
  vis_tile<T, ROW_COLS>(rows, n_tris, bins, counts, bin_width, tiles_x, band,
                     [&](int row, int col, float z, int tid) {
                       const size_t gp = band.at(row, col);
                       z_out[gp] = z;
                       tid_out[gp] = tid;
                       store_winner(rows, tid, static_cast<float>(col) + 0.5f,
                                    static_cast<float>(row) + 0.5f, gp, plane_stride,
                                    nums_out, metas_out);
                     });
}

// Kernel 2.7: kernel 2.2's split of the pixels (raster_accum.cu) over
// gathered slices. GATHERED_ACCUM_WARPS warps a block, each a 32x8 region
// of the tile: region q = block * GATHERED_ACCUM_WARPS + warp of the
// tile's 16 (at 32x128) is 32 columns wide at strip q / 4, its rows at
// q % 4 (4 warps would be a block a strip, 2.2's layout; 1, a block a
// region, measured faster on phase 11's inputs, PERF.md). A slice is the next CHUNK entries
// of the bin in slot order; their fat rows are gathered by id into a ring
// slot (stage_slice_async, AHEAD slices ahead) and the warp runs 2.2's
// body on it (AccumPixels<true>, lane t live where entry t of the slice is
// a row).
constexpr int GATHERED_ACCUM_WARPS = 1;
constexpr int GATHERED_ACCUM_THREADS = GATHERED_ACCUM_WARPS * 32;

// Kernel 2.7's blocks a tile.
template <class T>
struct GatheredAccum {
  static constexpr int ROWS = T::H / REGION_H;   // regions down a tile
  static constexpr int BLOCKS = T::REGIONS_X * ROWS / GATHERED_ACCUM_WARPS;
};

template <class T>
__global__ void __launch_bounds__(GATHERED_ACCUM_THREADS)
raster_accum_gathered_kernel(const float* __restrict__ rows, int n_tris,
                             const int* __restrict__ bins, const int* __restrict__ counts,
                             int bin_width, int tiles_x, const float* __restrict__ z_base,
                             const float* __restrict__ light, float* __restrict__ acc_out,
                             int* __restrict__ cnt_out, int hp, int wp) {
  __shared__ __align__(16) float ring[RING_SLOTS * CHUNK_FLOATS];
  using G = GatheredAccum<T>;
  const int tile = blockIdx.x / G::BLOCKS;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int lane = threadIdx.x % 32;
  const int q = (blockIdx.x % G::BLOCKS) * GATHERED_ACCUM_WARPS + threadIdx.x / 32;
  const int rx = tx * T::W + (q / G::ROWS) * REGION_W;
  const int py0 = ty * T::H + (q % G::ROWS) * REGION_H;
  const Region region(rx, py0);
  AccumPixels<true> s;    // the caller's z_base may be negative: keep zv >= 0
  s.load(z_base, light, rx + lane, py0, Band{0, wp});   // the whole frame

  // bins and counts come from the caller: never walk past the bin row
  const int n = max(0, min(counts[tile], bin_width));
  const int* tbins = bins + static_cast<size_t>(tile) * bin_width;
  walk_ring<GATHERED_ACCUM_THREADS>(
      (n + CHUNK - 1) / CHUNK, ring,
      [&](float* slot, int k) {
        stage_slice_async<GATHERED_ACCUM_THREADS>(slot, rows, n_tris, tbins, k * CHUNK, n);
      },
      [&](const float* slot, int k) {
        s.add_slice(slot, tri_entry(tbins, k * CHUNK + lane, n, n_tris) >= 0, region);
      });
  s.store(acc_out, cnt_out, static_cast<size_t>(hp) * wp);
}

// Kernel 2.8: kernel 2.5's walk (peel_tile in raster_common.cuh) over the
// fat rows' first 12 columns, then 2.3's epilogue (store_layer) for the
// block's pixels.
template <class T>
__global__ void __cluster_dims__(PEEL_SPLIT, 1, 1) __launch_bounds__(T::THREADS, 2)
raster_peel_gathered_kernel(const float* __restrict__ rows, int n_tris,
                            const int* __restrict__ bins, const int* __restrict__ counts,
                            int bin_width, int tiles_x, const float* __restrict__ z_base,
                            const int* __restrict__ last, int* __restrict__ best_out,
                            float* __restrict__ nums_out, float* __restrict__ metas_out,
                            int hp, int wp) {
  const size_t plane_stride = static_cast<size_t>(hp) * wp;
  const Band band{0, wp};   // the whole frame
  peel_tile<T, ROW_COLS>(rows, n_tris, bins, counts, bin_width, tiles_x, z_base, last, band,
                      [&](int row, int col, int best) {
                        store_layer(rows, best, row, col, band, plane_stride, best_out,
                                    nums_out, metas_out);
                      });
}

// Kernels 2.6 and 2.8 at a tile of several passes (Tile): vis_tile_passes
// and peel_tile_passes, in dynamic shared memory, with the same
// epilogues.
template <class T>
__global__ void __launch_bounds__(T::THREADS, 2)
raster_fused_gathered_passes_kernel(const float* __restrict__ rows, int n_tris,
                                    const int* __restrict__ bins,
                                    const int* __restrict__ counts, int bin_width, int tiles_x,
                                    float* __restrict__ z_out, int* __restrict__ tid_out,
                                    float* __restrict__ nums_out,
                                    float* __restrict__ metas_out, int hp, int wp) {
  const size_t plane_stride = static_cast<size_t>(hp) * wp;
  const Band band{0, wp};   // the whole frame
  vis_tile_passes<T, ROW_COLS>(rows, n_tris, bins, counts, bin_width, tiles_x, band,
                               [&](int row, int col, float z, int tid) {
                                 const size_t gp = band.at(row, col);
                                 z_out[gp] = z;
                                 tid_out[gp] = tid;
                                 store_winner(rows, tid, static_cast<float>(col) + 0.5f,
                                              static_cast<float>(row) + 0.5f, gp,
                                              plane_stride, nums_out, metas_out);
                               });
}

template <class T>
__global__ void __cluster_dims__(PEEL_SPLIT, 1, 1) __launch_bounds__(T::THREADS, 2)
raster_peel_gathered_passes_kernel(const float* __restrict__ rows, int n_tris,
                                   const int* __restrict__ bins,
                                   const int* __restrict__ counts, int bin_width, int tiles_x,
                                   const float* __restrict__ z_base,
                                   const int* __restrict__ last, int* __restrict__ best_out,
                                   float* __restrict__ nums_out,
                                   float* __restrict__ metas_out, int hp, int wp) {
  const size_t plane_stride = static_cast<size_t>(hp) * wp;
  const Band band{0, wp};   // the whole frame
  peel_tile_passes<T, ROW_COLS>(rows, n_tris, bins, counts, bin_width, tiles_x, z_base, last,
                                band, [&](int row, int col, int best) {
                                  store_layer(rows, best, row, col, band, plane_stride, best_out,
                                              nums_out, metas_out);
                                });
}

// Kernels 2.6's and 2.8's *_passes instances set up for this device
// (prepare_launch).
template <class T>
int fused_gathered_prepare() {
  static Prepared ready;
  return prepare_launch(ready, raster_fused_gathered_passes_kernel<T>, T::THREADS,
                        VisSmem<T>::BYTES, VIS_SPLIT, 6);
}

template <class T>
int peel_gathered_prepare() {
  static Prepared ready;
  return prepare_launch(ready, raster_peel_gathered_passes_kernel<T>, T::THREADS,
                        PeelSmem<T>::BYTES, PEEL_SPLIT, 8);
}

}  // namespace

// Kernels 2.6, 2.7 and 2.8 at the tile, as raster_fused_setup does 2.1.
extern "C" int raster_fused_gathered_setup(int tile_h, int tile_w, int* bytes) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    if constexpr (T::PASSES == 1) {
      return block_smem(raster_fused_gathered_kernel<T>, 0, bytes);
    } else {
      const int err =
          block_smem(raster_fused_gathered_passes_kernel<T>, VisSmem<T>::BYTES, bytes);
      return err != 0 ? err : fused_gathered_prepare<T>();
    }
  });
}

extern "C" int raster_accum_gathered_setup(int tile_h, int tile_w, int* bytes) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    return block_smem(raster_accum_gathered_kernel<T>, 0, bytes);
  });
}

extern "C" int raster_peel_gathered_setup(int tile_h, int tile_w, int* bytes) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    if constexpr (T::PASSES == 1) {
      return block_smem(raster_peel_gathered_kernel<T>, 0, bytes);
    } else {
      const int err =
          block_smem(raster_peel_gathered_passes_kernel<T>, PeelSmem<T>::BYTES, bytes);
      return err != 0 ? err : peel_gathered_prepare<T>();
    }
  });
}

extern "C" int raster_fused_gathered_launch(const float* rows, int n_tris, const int* bins,
                                            const int* counts, int bin_width, int tiles_x,
                                            int tiles_y, int tile_h, int tile_w, float* z,
                                            int* tid, float* nums, float* metas,
                                            void* stream) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    if constexpr (T::PASSES == 1) {
      return launch_vis<T>(raster_fused_gathered_kernel<T>, tiles_x * tiles_y, 0, stream,
                           rows, n_tris, bins, counts, bin_width, tiles_x, z, tid, nums,
                           metas, tiles_y * T::H, tiles_x * T::W);
    } else {
      constexpr int bytes = VisSmem<T>::BYTES;
      const int err = fused_gathered_prepare<T>();
      if (err != 0) return err;
      return launch_vis<T>(raster_fused_gathered_passes_kernel<T>, tiles_x * tiles_y, bytes,
                           stream, rows, n_tris, bins, counts, bin_width, tiles_x, z, tid,
                           nums, metas, tiles_y * T::H, tiles_x * T::W);
    }
  });
}

extern "C" int raster_accum_gathered_launch(const float* rows, int n_tris, const int* bins,
                                            const int* counts, int bin_width, int tiles_x,
                                            int tiles_y, int tile_h, int tile_w,
                                            const float* z_base, const float* light,
                                            float* acc, int* cnt, void* stream) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    raster_accum_gathered_kernel<T><<<tiles_x * tiles_y * GatheredAccum<T>::BLOCKS,
                                      GATHERED_ACCUM_THREADS, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
        rows, n_tris, bins, counts, bin_width, tiles_x, z_base, light, acc, cnt,
        tiles_y * T::H, tiles_x * T::W);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int raster_peel_gathered_launch(const float* rows, int n_tris, const int* bins,
                                           const int* counts, int bin_width, int tiles_x,
                                           int tiles_y, int tile_h, int tile_w,
                                           const float* z_base, const int* last, int* best,
                                           float* nums, float* metas, void* stream) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    if constexpr (T::PASSES == 1) {
      raster_peel_gathered_kernel<T><<<tiles_x * tiles_y * PEEL_SPLIT, T::THREADS, 0,
                                       static_cast<cudaStream_t>(stream)>>>(
          rows, n_tris, bins, counts, bin_width, tiles_x, z_base, last, best, nums, metas,
          tiles_y * T::H, tiles_x * T::W);
    } else {
      constexpr int bytes = PeelSmem<T>::BYTES;
      const int err = peel_gathered_prepare<T>();
      if (err != 0) return err;
      raster_peel_gathered_passes_kernel<T><<<tiles_x * tiles_y * PEEL_SPLIT, T::THREADS,
                                              bytes, static_cast<cudaStream_t>(stream)>>>(
          rows, n_tris, bins, counts, bin_width, tiles_x, z_base, last, best, nums, metas,
          tiles_y * T::H, tiles_x * T::W);
    }
    return static_cast<int>(cudaGetLastError());
  });
}
