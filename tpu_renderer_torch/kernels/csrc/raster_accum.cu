// Kernel B: the untextured transparent accumulation.
//
// Replaces the Pallas kernel raster._accum_chunks_kernel of the JAX package
// (tpu_renderer/kernels/raster.py, launched by _accum_slab_call from
// rasterize_accum_slabs). mesh.frag writes alpha = 1, so the reference's
// additive blend reduces to a sum over every transparent fragment that
// passes the depth test against the opaque z. Per 32x128 tile the kernel
// walks the tile's bin entries in ascending chunk id, skips groups whose
// gmask bit is 0, and for every covered fragment with z >= z_base adds
// rgb * (max(light, 0.1) * power + ambient) and counts it. Float addition is
// order-dependent, so each pixel adds in ascending triangle order, the order
// of the plain PyTorch version and of the JAX kernel.
//
// What bounds it on the H100: per-pixel ALU work over bin entries (the edge
// and depth planes for every live triangle, plus 5 planes and one IEEE
// divide for each fragment taken), not bytes: 6 KB of fat rows per entry
// against ~16-40 float operations per triangle per pixel over 4096 pixels.
// As in raster_fused.cu, the densest tile's serial walk sets the time.
// What the design does about it: one block per tile, 256 threads x 16
// pixels with the sums, counts and opaque depth in registers; the chunk's
// rows staged once in shared memory; dead groups skipped on the gmask bit;
// shading math only for the fragments actually taken.

#include "raster_common.cuh"

namespace {

using namespace tr;

__global__ void __launch_bounds__(THREADS)
raster_accum_kernel(const float* __restrict__ rows, const int* __restrict__ bins,
                    const int* __restrict__ counts, int bin_width, int n_chunks,
                    int tiles_x, const float* __restrict__ z_base, const float* __restrict__ light,
                    float* __restrict__ acc_out, int* __restrict__ cnt_out, int hp,
                    int wp) {
  __shared__ float srow[CHUNK * ROW_COLS];
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int col = threadIdx.x % TILE_W;
  const int row0 = threadIdx.x / TILE_W;
  const float x = static_cast<float>(tx * TILE_W + col) + 0.5f;
  // light: [sun_dir xyz (baked into the light numerator at setup), power,
  // ambient rgb, 0]
  const float power = light[3];
  const float amb[3] = {light[4], light[5], light[6]};

  float y[PIX], zb[PIX], acc[3][PIX];
  int cnt[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const int py = ty * TILE_H + row0 + i * ROWS_PER_PASS;
    y[i] = static_cast<float>(py) + 0.5f;
    zb[i] = z_base[static_cast<size_t>(py) * wp + tx * TILE_W + col];
    acc[0][i] = acc[1][i] = acc[2][i] = 0.0f;
    cnt[i] = 0;
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
        const float* r = srow + t * ROW_COLS;
        Tri tri;
        tri.load(r);
#pragma unroll
        for (int i = 0; i < PIX; ++i) {
          float zv;
          // zv >= 0 is subsumed by zv >= z_base (opaque depth, >= 0)
          if (!(tri.covers(x, y[i], &zv) && zv >= zb[i])) continue;
          // numerators in columns 13-16 / 19-22 / 25-28, den in 41-43
          add_fragment(r + 13, 6, r + 41, x, y[i], power, amb, &acc[0][i], &acc[1][i],
                       &acc[2][i]);
          cnt[i] += 1;
        }
      }
    }
  }

  const size_t plane_stride = static_cast<size_t>(hp) * wp;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const size_t p = static_cast<size_t>(ty * TILE_H + row0 + i * ROWS_PER_PASS) * wp +
                     tx * TILE_W + col;
#pragma unroll
    for (int c = 0; c < 3; ++c) acc_out[c * plane_stride + p] = acc[c][i];
    cnt_out[p] = cnt[i];
  }
}

}  // namespace

extern "C" int raster_accum_launch(const float* rows, const int* bins,
                                   const int* counts, int bin_width, int n_chunks,
                                   int tiles_x, int tiles_y,
                                   const float* z_base, const float* light,
                                   float* acc, int* cnt, void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  raster_accum_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, bins, counts, bin_width, n_chunks, tiles_x, z_base, light, acc, cnt,
      tiles_y * TILE_H, tiles_x * TILE_W);
  return static_cast<int>(cudaGetLastError());
}
