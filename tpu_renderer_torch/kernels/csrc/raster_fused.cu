// Kernel 2.1: the opaque fused raster.
//
// Replaces the Pallas kernel raster._chunks_stream_loop of the JAX package
// (tpu_renderer/kernels/raster.py, launched as _raster_chunks_fresh_kernel /
// _raster_chunks_state_kernel from rasterize_fused_slabs). Per tile it
// walks the tile's bin entries (cid << ENTRY_SHIFT | gmask) in bin order;
// for each group whose gmask bit is set it tests every triangle's 3 edge
// planes (top-left fill rule) and depth plane at each pixel center, keeping
// z and tid with reversed-Z `>=` and later-wins on ties. After the walk each
// covered pixel reads its winner's fat row once and writes the 4 numerator
// planes and the 15 constant planes (the JAX kernel re-selects them per
// chunk; the final planes are the last winner's either way).
//
// What bounds it on the H100: per-pixel ALU work over bin entries — 4
// planes (~16 float operations) per triangle per pixel, against 6 KB of
// fat rows read once per entry — and, unless the work is spread, the
// densest tile: on the bench frame one tile holds 154 entries (589 live
// groups) against a mean of 5, while the ALU work of all tiles together
// would take 0.06 ms at the fp32 peak. With this design (measured on an
// H100 80GB HBM3 at 700 W, bench frame, 0.46-0.51 ms) about 0.13 ms is the
// launch, merge and epilogue of the 4,080 blocks (21 output planes, 175 MB
// at 1080p) and about 0.25 ms the densest tile's 8 segments of ~75 live
// groups each: SPLIT = 8 is the portable cluster's limit.
// What the design does about it:
// * a cluster of SPLIT blocks per tile (__cluster_dims__): the tile's
//   entries are cut into contiguous segments, one for every SEG_MIN
//   entries and at most SPLIT, one a block. The winner at a pixel is the last
//   triangle in walk order with the largest z, so per-segment winners fold
//   exactly, in segment order, with the walk's own rule (take if the
//   segment has a winner and its z >= the running z). The blocks exchange
//   (z, tid) through distributed shared memory; each then runs the epilogue
//   for its 1/SPLIT of the tile's pixels. No global scratch, one launch.
//   The z carried is the winner's own, so -0.0 and +0.0 tie as `>=` ties
//   them and the output keeps the winner's bits.
// * each warp owns a compact 32x8 region (one column a lane, 8 rows) and
//   skips, on warp-uniform branches, every triangle whose edge planes miss
//   the region and, for the others, every row they miss (edge_rows in
//   raster_common.cuh: exact, with a rounding margin; the screen boxes of
//   columns 44-47 are not used, since they are clipped to the unpadded
//   extent and the pad rows and columns are rasterised too). A lane
//   decides for one triangle of the chunk; the small triangles of a dense
//   tile touch one region and two or three of its rows.
// * chunks e + 1 and e + 2 are copied into a 4-slot shared-memory ring
//   (cp.async) while chunk e is rasterised.
// * the attribute planes are evaluated once per pixel in the epilogue.
// Rounding: -fmad=false and spelled-out __fmaf_rn plane evaluation (as XLA
// contracts the reference on the CPU), so the result is bit-exact against
// the plain PyTorch version. That rules out the tensor cores: a TF32 or
// bf16 product of the edge planes would not round as the reference does.

#include <cooperative_groups.h>

#include "raster_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace tr;

constexpr int SPLIT = 8;       // blocks a tile: the cluster (portable maximum)
constexpr int SEG_MIN = 4;     // a segment for every SEG_MIN entries
constexpr int F_PIX = REGION_H;   // 8 pixels a thread

// A warp's walk of entries [e0, e1) of a tile's bin over its 32x8 region
// (x: its lane's pixel column center, py0: the region's first row), from
// (DEPTH_CLEAR, -1): per pixel the reversed-Z (>=) winner, a later entry
// winning an equal z, into (z, tid). Both forms of 2.1 walk a region with
// it. Every thread of the block must call it (walk_entries).
template <class T>
__device__ __forceinline__ void fused_walk(const float* __restrict__ rows, const int* tbins,
                                           int e0, int e1, int n_chunks, float* ring,
                                           const Region& region, float x, int py0,
                                           float (&z)[F_PIX], int (&tid)[F_PIX]) {
#pragma unroll
  for (int i = 0; i < F_PIX; ++i) {
    z[i] = 0.0f;  // DEPTH_CLEAR
    tid[i] = -1;
  }
  walk_entries<T::THREADS>(rows, tbins, e0, e1, n_chunks, ring,
                           [&](const float* slot, int cid, int gmask) {
    const unsigned rows_of = lane_rows(slot, gmask, region);
    unsigned m = __ballot_sync(FULL_WARP, rows_of != 0);
    while (m) {
      const int t = __ffs(m) - 1;
      m &= m - 1;
      const unsigned rows_t = __shfl_sync(FULL_WARP, rows_of, t);
      Tri tri;
      tri.load(slot + t * ROW_COLS);
      const int id = cid * CHUNK + t;
#pragma unroll
      for (int i = 0; i < F_PIX; ++i) {
        if (!((rows_t >> i) & 1)) continue;   // uniform across the warp
        float zv;
        // zv >= 0 is subsumed by zv >= z (z starts at 0)
        if (tri.covers(x, static_cast<float>(py0 + i) + 0.5f, &zv) && zv >= z[i]) {
          z[i] = zv;
          tid[i] = id;
        }
      }
    }
  });
}

// T::THREADS threads a block (512 at 32x128 tiles), a warp a 32x8 region.
template <class T>
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(T::THREADS, 2)
raster_fused_kernel(const float* __restrict__ rows, const int* __restrict__ bins,
                    const int* __restrict__ counts, int bin_width, int n_chunks,
                    int tiles_x, int tile_y0, float* __restrict__ z_out,
                    int* __restrict__ tid_out, float* __restrict__ nums_out,
                    float* __restrict__ metas_out, int hp, int wp) {
  static_assert(T::PIX == SPLIT * T::THREADS, "the epilogue gives each thread one pixel");
  // the walk's chunk ring, then the segment's (z, tid) for the merge: one
  // array of the larger (the merge's at 32x128 tiles, the ring's below)
  constexpr int MERGE = 2 * T::PIX;
  constexpr int RING = RING_SLOTS * CHUNK_FLOATS;
  __shared__ __align__(16) float smem[MERGE > RING ? MERGE : RING];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / SPLIT;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x + tile_y0;   // the frame's tile row (Band)
  const Band band{tile_y0 * T::H, wp};
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rx0 = (warp % T::REGIONS_X) * REGION_W;   // region in the tile
  const int ry0 = (warp / T::REGIONS_X) * REGION_H;
  const int px = tx * T::W + rx0 + lane;
  const int py0 = ty * T::H + ry0;
  const float x = static_cast<float>(px) + 0.5f;
  const Region region(tx * T::W + rx0, py0);

  // bins and counts come from the caller: never walk past the bin row
  // or read a chunk that is not there
  const int n = max(0, min(counts[tile], bin_width));
  int e0, e1;
  const int segs = tile_segment(n, SPLIT, SEG_MIN, rank, &e0, &e1);

  float z[F_PIX];
  int tid[F_PIX];
  fused_walk<T>(rows, bins + static_cast<size_t>(tile) * bin_width, e0, e1, n_chunks, smem,
                region, x, py0, z, tid);

  // the merge: segment winners in segment order, the walk's own rule
  float* zs = smem;
  int* ts = reinterpret_cast<int*>(smem + T::PIX);
  if (rank < segs) {
#pragma unroll
    for (int i = 0; i < F_PIX; ++i) {
      const int p = (ry0 + i) * T::W + rx0 + lane;
      zs[p] = z[i];
      ts[p] = tid[i];
    }
  }
  cluster.sync();
  const int p = rank * T::THREADS + threadIdx.x;
  float zw = 0.0f;
  int tw = -1;
  for (int q = 0; q < segs; ++q) {
    const float zq = cluster.map_shared_rank(zs, q)[p];
    const int tq = cluster.map_shared_rank(ts, q)[p];
    if (tq >= 0 && zq >= zw) {
      zw = zq;
      tw = tq;
    }
  }
  cluster.sync();   // no block leaves while another reads its shared memory

  const int row = ty * T::H + p / T::W;
  const int col = tx * T::W + p % T::W;
  const size_t plane_stride = static_cast<size_t>(hp) * wp;
  const size_t gp = band.at(row, col);
  z_out[gp] = zw;
  tid_out[gp] = tw;
  store_winner(rows, tw, static_cast<float>(col) + 0.5f, static_cast<float>(row) + 0.5f, gp,
               plane_stride, nums_out, metas_out);
}

// raster_fused_passes_kernel's dynamic shared memory, in floats: the
// walk's chunk ring, then the tile's (z, tid) for the merge, kept from
// pass to pass.
template <class T>
struct FusedSmem {
  static constexpr int RING = RING_SLOTS * CHUNK_FLOATS;
  static constexpr int BYTES = (RING + 2 * T::PIX) * 4;
};

// raster_fused_kernel for a tile of several passes (Tile): each pass's
// warps walk their regions over the block's segment and park their
// (z, tid) in the merge buffer; after the last pass the merge and the
// epilogue run for the block's 1/SPLIT of the tile's pixels, T::PASSES a
// thread.
template <class T>
__global__ void __cluster_dims__(SPLIT, 1, 1) __launch_bounds__(T::THREADS, 2)
raster_fused_passes_kernel(const float* __restrict__ rows, const int* __restrict__ bins,
                           const int* __restrict__ counts, int bin_width, int n_chunks,
                           int tiles_x, int tile_y0, float* __restrict__ z_out,
                           int* __restrict__ tid_out, float* __restrict__ nums_out,
                           float* __restrict__ metas_out, int hp, int wp) {
  static_assert(T::PASSES > 1, "a tile of one pass takes raster_fused_kernel");
  float* ring = dynamic_smem();
  float* zs = ring + FusedSmem<T>::RING;
  int* ts = reinterpret_cast<int*>(zs + T::PIX);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / SPLIT;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x + tile_y0;   // the frame's tile row (Band)
  const Band band{tile_y0 * T::H, wp};
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // bins and counts come from the caller: never walk past the bin row
  // or read a chunk that is not there
  const int n = max(0, min(counts[tile], bin_width));
  int e0, e1;
  const int segs = tile_segment(n, SPLIT, SEG_MIN, rank, &e0, &e1);
  const int* tbins = bins + static_cast<size_t>(tile) * bin_width;

  for (int pass = 0; pass < T::PASSES; ++pass) {
    const int q = pass * T::WARPS + warp;
    const int rx0 = region_x0<T>(q);   // region in the tile
    const int ry0 = region_y0<T>(q);
    const int px = tx * T::W + rx0 + lane;
    const int py0 = ty * T::H + ry0;
    const float x = static_cast<float>(px) + 0.5f;
    const Region region(tx * T::W + rx0, py0);
    float z[F_PIX];
    int tid[F_PIX];
    fused_walk<T>(rows, tbins, e0, e1, n_chunks, ring, region, x, py0, z, tid);
    if (rank < segs) {
#pragma unroll
      for (int i = 0; i < F_PIX; ++i) {
        const int p = (ry0 + i) * T::W + rx0 + lane;
        zs[p] = z[i];
        ts[p] = tid[i];
      }
    }
  }

  // the merge: segment winners in segment order, the walk's own rule
  cluster.sync();
  float zw[T::PASSES];
  int tw[T::PASSES];
#pragma unroll
  for (int j = 0; j < T::PASSES; ++j) {
    const int p = merged_pixel<T, SPLIT>(rank, j);
    zw[j] = 0.0f;
    tw[j] = -1;
    for (int q = 0; q < segs; ++q) {
      const float zq = cluster.map_shared_rank(zs, q)[p];
      const int tq = cluster.map_shared_rank(ts, q)[p];
      if (tq >= 0 && zq >= zw[j]) {
        zw[j] = zq;
        tw[j] = tq;
      }
    }
  }
  cluster.sync();   // no block leaves while another reads its shared memory

  const size_t plane_stride = static_cast<size_t>(hp) * wp;
#pragma unroll
  for (int j = 0; j < T::PASSES; ++j) {
    const int p = merged_pixel<T, SPLIT>(rank, j);
    const int row = ty * T::H + p / T::W;
    const int col = tx * T::W + p % T::W;
    const size_t gp = band.at(row, col);
    z_out[gp] = zw[j];
    tid_out[gp] = tw[j];
    store_winner(rows, tw[j], static_cast<float>(col) + 0.5f, static_cast<float>(row) + 0.5f,
                 gp, plane_stride, nums_out, metas_out);
  }
}

// Kernel 2.1's *_passes instance set up for this device (prepare_launch).
template <class T>
int fused_prepare() {
  static Prepared ready;
  return prepare_launch(ready, raster_fused_passes_kernel<T>, T::THREADS, FusedSmem<T>::BYTES,
                        SPLIT, 1);
}

}  // namespace

// Kernel 2.1 at the tile, before any launch: the shared memory a block
// takes into *bytes (block_smem), and at a tile of passes the instance
// set up, which refuses (cudaErrorInvalidConfiguration) where no cluster
// fits on the card. kernels/_build.py runs every raster_*_setup when it
// loads a tile's library.
extern "C" int raster_fused_setup(int tile_h, int tile_w, int* bytes) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    if constexpr (T::PASSES == 1) {
      return block_smem(raster_fused_kernel<T>, 0, bytes);
    } else {
      const int err = block_smem(raster_fused_passes_kernel<T>, FusedSmem<T>::BYTES, bytes);
      return err != 0 ? err : fused_prepare<T>();
    }
  });
}

extern "C" int raster_fused_launch(const float* rows, const int* bins,
                                   const int* counts, int bin_width, int n_chunks,
                                   int tiles_x, int tiles_y, int tile_h, int tile_w,
                                   int tile_y0, float* z, int* tid, float* nums,
                                   float* metas, void* stream) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    if constexpr (T::PASSES == 1) {
      raster_fused_kernel<T><<<tiles_x * tiles_y * SPLIT, T::THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
          rows, bins, counts, bin_width, n_chunks, tiles_x, tile_y0, z, tid, nums, metas,
          tiles_y * T::H, tiles_x * T::W);
    } else {
      constexpr int bytes = FusedSmem<T>::BYTES;
      const int err = fused_prepare<T>();
      if (err != 0) return err;
      raster_fused_passes_kernel<T><<<tiles_x * tiles_y * SPLIT, T::THREADS, bytes,
                                      static_cast<cudaStream_t>(stream)>>>(
          rows, bins, counts, bin_width, n_chunks, tiles_x, tile_y0, z, tid, nums, metas,
          tiles_y * T::H, tiles_x * T::W);
    }
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" const char* raster_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// What cudaOccupancyMaxActiveClusters found for this library's instance
// of kernel 2.k at a tile of several passes (prepare_launch; 0 where none
// was set up).
extern "C" int raster_max_clusters(int k) {
  return k >= 0 && k < 9 ? max_clusters[k].load() : 0;
}
