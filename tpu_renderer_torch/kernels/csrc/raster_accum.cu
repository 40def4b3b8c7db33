// Kernel 2.2: the untextured transparent accumulation.
//
// Replaces the Pallas kernel raster._accum_chunks_kernel of the JAX package
// (tpu_renderer/kernels/raster.py, launched by _accum_slab_call from
// rasterize_accum_slabs). mesh.frag writes alpha = 1, so the reference's
// additive blend reduces to a sum over every transparent fragment that
// passes the depth test against the opaque z. Per tile the kernel
// walks the tile's bin entries in bin order, skips groups whose gmask bit
// is 0, and for every covered fragment with z >= z_base adds
// rgb * (max(light, 0.1) * power + ambient) and counts it. Float addition is
// order-dependent, so each pixel adds in ascending triangle order, the order
// of the plain PyTorch version and of the JAX kernel.
//
// What bounds it on the H100: per-pixel ALU work over bin entries (the edge
// and depth planes for every live triangle, plus 5 planes and one IEEE
// divide for each fragment taken), not bytes: 6 KB of fat rows per entry
// against ~16-40 float operations per triangle per pixel. A tile's walk is
// serial, so the densest tile (24 entries on the bench frame) sets the time
// unless its pixels are spread; with them spread (measured on an H100
// 80GB HBM3 at 700 W, bench frame, 0.19-0.23 ms) it still sets ~0.11 ms of
// it, the launch and the write of the sums 0.04-0.07.
// What the design does about it: the sum's order forbids splitting the
// entry list, so the pixels are split instead. SPLIT blocks a tile, each a
// 32-column strip, each walking the tile's whole entry list in order; a
// warp owns a 32x8 region (8 pixels a thread, with the sums, count and
// opaque depth in registers) and skips, on warp-uniform branches, every
// triangle whose edge planes miss the region and every row they miss
// (edge_rows in raster_common.cuh: exact, so each pixel's sequence of adds
// is unchanged). The per-chunk body (AccumPixels in raster_common.cuh) is
// kernel 2.7's too.
// Chunks e + 1 and e + 2 are copied into a 4-slot shared-memory ring
// (cp.async) while chunk e is rasterised. Shading math runs only for the fragments taken.
// Rounding: -fmad=false and spelled-out __fmaf_rn plane evaluation, the
// IEEE divide and the NaN-propagating max of add_fragment, so the sums are
// bit-exact against the plain version; the tensor cores are ruled out for
// the same reason (TF32 or bf16 products would not round as the reference).

#include "raster_common.cuh"

namespace {

using namespace tr;

// T::REGIONS_X blocks a tile, one a 32-column strip (4 at 32x128 tiles),
// each a warp a 32x8 region of its strip (128 threads at 32x128). A strip
// of more than MAX_WARPS regions (tile_h above 128) is walked in PASSES
// passes of WARPS regions, as Tile's are.
template <class T>
struct Strip {
  static constexpr int ROWS = T::H / REGION_H;   // regions down a strip
  static constexpr int WARPS = largest_divisor(ROWS, MAX_WARPS);
  static constexpr int THREADS = WARPS * 32;
  static constexpr int PASSES = ROWS / WARPS;
};

template <class T>
__global__ void __launch_bounds__(Strip<T>::THREADS)
raster_accum_kernel(const float* __restrict__ rows, const int* __restrict__ bins,
                    const int* __restrict__ counts, int bin_width, int n_chunks,
                    int tiles_x, int tile_y0, const float* __restrict__ z_base,
                    const float* __restrict__ light,
                    float* __restrict__ acc_out, int* __restrict__ cnt_out, int hp,
                    int wp) {
  __shared__ __align__(16) float ring[RING_SLOTS * CHUNK_FLOATS];
  const int tile = blockIdx.x / T::REGIONS_X;
  const int strip = blockIdx.x % T::REGIONS_X;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x + tile_y0;   // the frame's tile row (Band)
  const Band band{tile_y0 * T::H, wp};
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // bins and counts come from the caller: never walk past the bin row
  // or read a chunk that is not there
  const int n = max(0, min(counts[tile], bin_width));
  const int* tbins = bins + static_cast<size_t>(tile) * bin_width;
  for (int pass = 0; pass < Strip<T>::PASSES; ++pass) {
    const int py0 = ty * T::H + (pass * Strip<T>::WARPS + warp) * REGION_H;
    const Region region(tx * T::W + strip * REGION_W, py0);
    AccumPixels<false> s;   // zv >= 0 is subsumed by zv >= z_base (opaque depth, >= 0)
    s.load(z_base, light, tx * T::W + strip * REGION_W + lane, py0, band);
    walk_entries<Strip<T>::THREADS>(rows, tbins, 0, n, n_chunks, ring,
                            [&](const float* slot, int, int gmask) {
      s.add_slice(slot, (gmask >> (lane / GROUP)) & 1, region);
    });
    s.store(acc_out, cnt_out, static_cast<size_t>(hp) * wp);
  }
}

}  // namespace

// Kernel 2.2 at the tile: the shared memory a block takes into *bytes
// (block_smem; raster_fused_setup says who runs it).
extern "C" int raster_accum_setup(int tile_h, int tile_w, int* bytes) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    return block_smem(raster_accum_kernel<T>, 0, bytes);
  });
}

extern "C" int raster_accum_launch(const float* rows, const int* bins,
                                   const int* counts, int bin_width, int n_chunks,
                                   int tiles_x, int tiles_y, int tile_h, int tile_w,
                                   int tile_y0, const float* z_base, const float* light,
                                   float* acc, int* cnt, void* stream) {
  return with_tile(tile_h, tile_w, [&](auto tile) {
    using T = decltype(tile);
    raster_accum_kernel<T><<<tiles_x * tiles_y * T::REGIONS_X, Strip<T>::THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        rows, bins, counts, bin_width, n_chunks, tiles_x, tile_y0, z_base, light, acc, cnt,
        tiles_y * T::H, tiles_x * T::W);
    return static_cast<int>(cudaGetLastError());
  });
}
