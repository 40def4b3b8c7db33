// Kernel 2.3: one textured-transparency peel over dense chunk bins.
//
// Replaces the Pallas kernel raster._peel_stream_loop of the JAX package
// (tpu_renderer/kernels/raster.py, launched as _peel_chunks_fresh_kernel /
// _peel_chunks_state_kernel through _peel_slab_call from
// rasterize_peel_slabs). Per pixel it finds the smallest triangle id greater
// than last[pixel] that covers the pixel (top-left fill rule, z <= 1) and
// passes the depth test z >= z_base[pixel] against the opaque depth: the
// next layer in submission order, the order the reference blends its
// transparent draws in (vk_engine.cpp:1459-1465). A bin entry is
// cid << ENTRY_SHIFT | gmask; groups whose gmask bit is 0 are skipped. After
// the walk each pixel with a layer reads that triangle's fat row once and
// writes its 4 numerator and 15 constant planes. The JAX kernel re-selects
// those planes after every group; the final planes are the layer's either
// way.
//
// What bounds it on the H100: per-pixel ALU work over bin entries (3 edge
// planes and the depth plane, ~16 float operations, per live triangle per
// pixel) against 6 KB of fat rows an entry, and, unless the work is
// spread, the densest tile's serial walk: on the textured-glass frame one
// tile holds 33 entries against a mean of 1.7. With this design (measured
// on an H100 80GB HBM3 at 700 W, that frame's first peel, 0.20 ms) about
// 0.14 ms is the launch of the 4,080 blocks and the epilogue's 20 output
// planes (167 MB at 1080p), the rest the densest tiles' segments.
// What the design does about it (kernel 2.1's, raster_fused.cu, with a
// min for a merge):
// * a cluster of PEEL_SPLIT blocks per tile (__cluster_dims__): the tile's
//   entries are cut into contiguous segments, one for every PEEL_SEG_MIN
//   entries and at most PEEL_SPLIT, one a block. Each block walks its
//   segment from ID_INF; the layer is the min over the segments' layers,
//   which the blocks exchange through distributed shared memory (a min has
//   no order, and each segment's layer is the min of its entries). Each
//   block then runs the epilogue for its 1/PEEL_SPLIT of the tile's pixels.
//   A tile of one segment (most tiles) is block 0's alone: the other
//   blocks leave at once, and there is no merge and no cluster barrier.
//   One launch, no global scratch, no host sync: the kernel reads counts.
// * each warp owns a compact 32x8 region (one column a lane, 8 rows) and
//   skips, on warp-uniform branches, every triangle whose edge planes miss
//   the region, every row they miss (edge_rows, exact with its rounding
//   margin), and every chunk whose ids are all <= the region's smallest
//   `last` (no pixel there can take them).
// * exact stops: a segment whose chunk ids strictly ascend (checked, any
//   bin order is taken) can never change a pixel that holds a layer; a warp
//   whose pixels all hold one skips its tests, a block whose pixels all do
//   leaves its walk at the ring's next barrier (__syncthreads_and). A pixel
//   whose `last` is the table's largest id is settled in any order.
// * chunks e + 1 and e + 2 are copied into a 4-slot shared-memory ring
//   (cp.async) while chunk e is rasterised.
// Rounding: -fmad=false and spelled-out __fmaf_rn plane evaluation, so the
// result is bit-exact against the plain PyTorch version; no tensor cores
// (raster_fused.cu says why).

#include "raster_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tr;

constexpr int PEEL_SEG_MIN = 4;   // a segment for every PEEL_SEG_MIN entries

// A warp's walk of entries [e0, e1) of a tile's dense chunk bin over its
// 32x8 region, into s (loaded with the region's opaque depth and `last`):
// the chunks that hold no id past the region's smallest `last` are
// skipped, and the walk stops where every pixel is settled (keys_ascend
// says where a layer settles a pixel). Both forms of 2.3 walk a region
// with it. Every thread of the block must call it (walk_entries).
template <class T>
__device__ __forceinline__ void peel_fused_walk(const float* __restrict__ rows,
                                                const int* tbins, int e0, int e1, int n_chunks,
                                                float* ring, const Region& region,
                                                PeelPixels<false>& s) {
  const int lane = threadIdx.x % 32;
  s.ascending = keys_ascend<T::THREADS>(tbins, e0, e1, ENTRY_SHIFT);
  walk_entries<T::THREADS>(rows, tbins, e0, e1, n_chunks, ring,
                           [&](const float* slot, int cid, int gmask) {
    const int base = cid * CHUNK;
    // uniform across the warp: no id of the chunk passes id > last, or
    // every pixel of the region is settled
    if (base + CHUNK - 1 <= s.lt_min || __all_sync(FULL_WARP, s.settled())) return;
    const unsigned rows_of = base + lane > s.lt_min ? lane_rows(slot, gmask, region) : 0u;
    unsigned m = __ballot_sync(FULL_WARP, rows_of != 0);
    while (m) {
      const int t = __ffs(m) - 1;
      m &= m - 1;
      Tri tri;
      tri.load(slot + t * ROW_COLS);
      s.take(tri, base + t, __shfl_sync(FULL_WARP, rows_of, t));
    }
  }, [&] { return s.settled(); });
}

// T::THREADS threads a block (512 at 32x128 tiles), a warp a 32x8 region.
template <class T>
__global__ void __cluster_dims__(PEEL_SPLIT, 1, 1) __launch_bounds__(T::THREADS, 2)
raster_peel_fused_kernel(const float* __restrict__ rows, const int* __restrict__ bins,
                         const int* __restrict__ counts, int bin_width, int n_chunks,
                         int tiles_x, int tile_y0, const float* __restrict__ z_base,
                         const int* __restrict__ last, int* __restrict__ best_out,
                         float* __restrict__ nums_out, float* __restrict__ metas_out,
                         int hp, int wp) {
  static_assert(T::PIX * sizeof(int) <= RING_SLOTS * CHUNK_FLOATS * sizeof(float),
                "the merge buffer fits the ring");
  // the walk's chunk ring, then the segment's layer ids for the merge
  __shared__ __align__(16) float smem[RING_SLOTS * CHUNK_FLOATS];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / PEEL_SPLIT;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x + tile_y0;   // the frame's tile row (Band)
  const Band band{tile_y0 * T::H, wp};
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rx0 = (warp % T::REGIONS_X) * REGION_W;   // region in the tile
  const int ry0 = (warp / T::REGIONS_X) * REGION_H;
  const Region region(tx * T::W + rx0, ty * T::H + ry0);
  // bins and counts come from the caller: never walk past the bin row
  // or read a chunk that is not there
  const int n = max(0, min(counts[tile], bin_width));
  int e0, e1;
  const int segs = tile_segment(n, PEEL_SPLIT, PEEL_SEG_MIN, rank, &e0, &e1);
  // a tile of one segment is block 0's alone: no merge, no cluster barrier
  if (segs == 1 && rank > 0) return;
  const size_t plane_stride = static_cast<size_t>(hp) * wp;
  auto emit = [&](int row, int col, int best) {
    store_layer(rows, best, row, col, band, plane_stride, best_out, nums_out, metas_out);
  };

  PeelPixels<false> s;
  if (rank < segs) {   // uniform across the block
    s.load(z_base, last, tx * T::W + rx0 + lane, ty * T::H + ry0, band,
           n_chunks * CHUNK - 1);
    peel_fused_walk<T>(rows, bins + static_cast<size_t>(tile) * bin_width, e0, e1, n_chunks,
                       smem, region, s);
  }
  if (segs == 1) {
#pragma unroll
    for (int i = 0; i < REGION_H; ++i)
      emit(ty * T::H + ry0 + i, tx * T::W + rx0 + lane, s.best[i]);
    return;
  }
  const int best =
      merge_min<T>(cluster, reinterpret_cast<int*>(smem), s, rx0, ry0, rank, segs);
  const int p = rank * T::THREADS + threadIdx.x;
  emit(ty * T::H + p / T::W, tx * T::W + p % T::W, best);
}

// raster_peel_fused_passes_kernel's dynamic shared memory, in floats: the
// walk's chunk ring, then the tile's layer ids for the merge, kept from
// pass to pass.
template <class T>
struct PeelFusedSmem {
  static constexpr int RING = RING_SLOTS * CHUNK_FLOATS;
  static constexpr int BYTES = (RING + T::PIX) * 4;
};

// raster_peel_fused_kernel for a tile of several passes (Tile): each
// pass's warps walk their regions over the block's segment, with its
// reject and stops, and park their layer ids (park_best); after the last
// pass the merge (merge_min_passes) and the epilogue run for the block's
// 1/PEEL_SPLIT of the tile's pixels, T::PASSES a thread.
template <class T>
__global__ void __cluster_dims__(PEEL_SPLIT, 1, 1) __launch_bounds__(T::THREADS, 2)
raster_peel_fused_passes_kernel(const float* __restrict__ rows, const int* __restrict__ bins,
                                const int* __restrict__ counts, int bin_width, int n_chunks,
                                int tiles_x, int tile_y0, const float* __restrict__ z_base,
                                const int* __restrict__ last, int* __restrict__ best_out,
                                float* __restrict__ nums_out, float* __restrict__ metas_out,
                                int hp, int wp) {
  static_assert(T::PASSES > 1, "a tile of one pass takes raster_peel_fused_kernel");
  float* ring = dynamic_smem();
  int* merge = reinterpret_cast<int*>(ring + PeelFusedSmem<T>::RING);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / PEEL_SPLIT;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x + tile_y0;   // the frame's tile row (Band)
  const Band band{tile_y0 * T::H, wp};
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // bins and counts come from the caller: never walk past the bin row
  // or read a chunk that is not there
  const int n = max(0, min(counts[tile], bin_width));
  int e0, e1;
  const int segs = tile_segment(n, PEEL_SPLIT, PEEL_SEG_MIN, rank, &e0, &e1);
  // a tile of one segment is block 0's alone: no merge, no cluster barrier
  if (segs == 1 && rank > 0) return;
  const size_t plane_stride = static_cast<size_t>(hp) * wp;
  auto emit = [&](int row, int col, int best) {
    store_layer(rows, best, row, col, band, plane_stride, best_out, nums_out, metas_out);
  };
  const int* tbins = bins + static_cast<size_t>(tile) * bin_width;

  for (int pass = 0; pass < T::PASSES; ++pass) {
    const int q = pass * T::WARPS + warp;
    const int rx0 = region_x0<T>(q);   // region in the tile
    const int ry0 = region_y0<T>(q);
    const Region region(tx * T::W + rx0, ty * T::H + ry0);
    PeelPixels<false> s;
    if (rank < segs) {   // uniform across the block
      s.load(z_base, last, tx * T::W + rx0 + lane, ty * T::H + ry0, band,
             n_chunks * CHUNK - 1);
      peel_fused_walk<T>(rows, tbins, e0, e1, n_chunks, ring, region, s);
    }
    if (segs == 1) {
#pragma unroll
      for (int i = 0; i < REGION_H; ++i)
        emit(ty * T::H + ry0 + i, tx * T::W + rx0 + lane, s.best[i]);
    } else {
      park_best<T>(merge, s, rx0, ry0, rank, segs);
    }
  }
  if (segs == 1) return;
  int best[T::PASSES];
  merge_min_passes<T>(cluster, merge, rank, segs, best);
#pragma unroll
  for (int j = 0; j < T::PASSES; ++j) {
    const int p = merged_pixel<T, PEEL_SPLIT>(rank, j);
    emit(ty * T::H + p / T::W, tx * T::W + p % T::W, best[j]);
  }
}

// Kernel 2.3's *_passes instance set up for this device (prepare_launch).
template <class T>
int peel_fused_prepare() {
  static Prepared ready;
  return prepare_launch(ready, raster_peel_fused_passes_kernel<T>, T::THREADS,
                        PeelFusedSmem<T>::BYTES, PEEL_SPLIT, 3);
}

}  // namespace

// Kernel 2.3 at the tile, as raster_fused_setup does 2.1.
extern "C" int raster_peel_fused_setup(int tile_h, int tile_w, int* bytes) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    if constexpr (T::PASSES == 1) {
      return block_smem(raster_peel_fused_kernel<T>, 0, bytes);
    } else {
      const int err =
          block_smem(raster_peel_fused_passes_kernel<T>, PeelFusedSmem<T>::BYTES, bytes);
      return err != 0 ? err : peel_fused_prepare<T>();
    }
  });
}

extern "C" int raster_peel_fused_launch(const float* rows, const int* bins,
                                        const int* counts, int bin_width, int n_chunks,
                                        int tiles_x, int tiles_y, int tile_h, int tile_w,
                                        int tile_y0, const float* z_base, const int* last,
                                        int* best,
                                        float* nums, float* metas, void* stream) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    if constexpr (T::PASSES == 1) {
      raster_peel_fused_kernel<T><<<tiles_x * tiles_y * PEEL_SPLIT, T::THREADS, 0,
                                    static_cast<cudaStream_t>(stream)>>>(
          rows, bins, counts, bin_width, n_chunks, tiles_x, tile_y0, z_base, last, best, nums,
          metas,
          tiles_y * T::H, tiles_x * T::W);
    } else {
      constexpr int bytes = PeelFusedSmem<T>::BYTES;
      const int err = peel_fused_prepare<T>();
      if (err != 0) return err;
      raster_peel_fused_passes_kernel<T><<<tiles_x * tiles_y * PEEL_SPLIT, T::THREADS, bytes,
                                           static_cast<cudaStream_t>(stream)>>>(
          rows, bins, counts, bin_width, n_chunks, tiles_x, tile_y0, z_base, last, best, nums,
          metas,
          tiles_y * T::H, tiles_x * T::W);
    }
    return static_cast<int>(cudaGetLastError());
  });
}
