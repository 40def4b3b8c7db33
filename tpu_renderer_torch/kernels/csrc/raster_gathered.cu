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
// The rule needs no order of the slots, so the walk never ends early.
//
// The JAX wrappers gather fat_rows[bins] into an (n_tiles, cap, 48) block
// first (802 MB at the deferred bench caps). Here a block reads rows by id
// from the table, staging only the columns the walk reads at every pixel:
// the 12 edge and depth coefficients (2.6, 2.8; 2.6 a batch of 512 entries
// in 26 KB, 2.8 of 256 in 12 KB), and for 2.7 also the numerator and
// denominator planes every taken fragment reads (columns 13-16, 19-22,
// 25-28, 41-43: 27 floats an entry, 27 KB for 256). All fit the static
// 48 KB; no dynamic shared memory. The winner's other columns are read
// once a pixel after the walk (store_winner), which equals the JAX
// kernel's select-at-take because the planes are a pure function of (row,
// pixel).
//
// The JAX kernels carry the id as a float in column 47 (exact below 2^24);
// the wrappers refuse a table of 2^24 rows or more. Entries past the
// tile's count are never read; an entry inside it that is no row of the
// table (negative, or >= T) is dropped, uniformly, where the JAX wrapper
// would clip it onto row 0 or T-1: the contract is counts <= bin width and
// live entries in [0, T).
//
// What bounds them on the H100: per-pixel ALU work, the 4 planes (~16 float
// operations) of a binned triangle at a pixel, plus for 2.7 five planes and
// a divide a fragment taken, against 48 B (108 B for 2.7) of table an
// entry; and, unless the work is spread, the densest tile: on the deferred
// frame's bins one tile holds 4,453 entries against a mean of 102.
// What the designs do about it:
// * 2.6 is kernel 2.4's design (vis_tile in raster_common.cuh, shared so
//   the two cannot drift apart): a cluster of VIS_SPLIT blocks a tile over
//   contiguous segments of the entries, each warp walking only the entries
//   and rows its 32x8 region may be covered by, the segments' (z, tid)
//   folded in segment order through distributed shared memory; then each
//   block runs store_winner for its 1/VIS_SPLIT of the tile's pixels. One
//   block a tile testing every entry at every pixel (2.6 before this
//   design) took 4.9 ms on the deferred frame's bins (H100 80GB HBM3, 700
//   W), 1% of its bound; this design 0.26-0.30 ms, 0.11-0.14 of it with no
//   entries (the launch and the 21 output planes).
// * 2.7 and 2.8: one block per 32x128 tile, 256 threads x 16 pixels with
//   the per-pixel state in registers; a batch's coefficients in shared
//   memory, read as broadcasts.
// The arithmetic is the stream kernels' own (raster_common.cuh), which is
// what makes the oracles exact.

#include "raster_common.cuh"

namespace {

using namespace tr;

constexpr int BATCH = THREADS;   // bin entries staged per pass
constexpr int ACCUM_COLS = 27;   // + numerators (4 x 3) and the denominator
// Offsets into a staged ACCUM_COLS entry: numerator a's (A, B, C)
// coefficients at NUM + a, NUM + 4 + a, NUM + 8 + a; then den (A, B, C).
constexpr int ACCUM_NUM = 12;
constexpr int ACCUM_NUM_STRIDE = 4;
constexpr int ACCUM_DEN = 24;

// Fat-row column of staged column c of an entry with N staged columns.
template <int N>
__device__ __forceinline__ int source_col(int c) {
  if (N == PLANE_COLS || c < PLANE_COLS) return c;
  if (c < ACCUM_DEN) return 13 + ((c - ACCUM_NUM) / ACCUM_NUM_STRIDE) * 6 +
                            (c - ACCUM_NUM) % ACCUM_NUM_STRIDE;
  return 41 + (c - ACCUM_DEN);
}

// Stage entries [base, base + BATCH) of a tile's bin: ids (-1 where the
// entry is past the count or no row of the table) and N columns of their
// fat rows. The caller synchronises before and after.
template <int N>
__device__ __forceinline__ void stage_entries(float* scoef, int* sid,
                                              const float* __restrict__ rows,
                                              int n_tris, const int* tbins, int base,
                                              int n) {
  const int k = base + static_cast<int>(threadIdx.x);
  int id = k < n ? tbins[k] : -1;
  if (id < 0 || id >= n_tris) id = -1;
  sid[threadIdx.x] = id;
  if (id >= 0) {
    const float* r = rows + static_cast<size_t>(id) * ROW_COLS;
#pragma unroll
    for (int c = 0; c < N; ++c) scoef[threadIdx.x * N + c] = r[source_col<N>(c)];
  }
}

// Kernel 2.6: kernel 2.4's walk and fold (vis_tile in raster_common.cuh)
// over the fat rows' first 12 columns, then the winner's planes for the
// block's pixels (store_winner, as 2.1's epilogue).
__global__ void __launch_bounds__(VIS_THREADS, 2)
raster_fused_gathered_kernel(const float* __restrict__ rows, int n_tris,
                             const int* __restrict__ bins, const int* __restrict__ counts,
                             int bin_width, int tiles_x, float* __restrict__ z_out,
                             int* __restrict__ tid_out, float* __restrict__ nums_out,
                             float* __restrict__ metas_out, int hp, int wp) {
  const size_t plane_stride = static_cast<size_t>(hp) * wp;
  vis_tile<ROW_COLS>(rows, n_tris, bins, counts, bin_width, tiles_x,
                     [&](int row, int col, float z, int tid) {
                       const size_t gp = static_cast<size_t>(row) * wp + col;
                       z_out[gp] = z;
                       tid_out[gp] = tid;
                       store_winner(rows, tid, static_cast<float>(col) + 0.5f,
                                    static_cast<float>(row) + 0.5f, gp, plane_stride,
                                    nums_out, metas_out);
                     });
}

__global__ void __launch_bounds__(THREADS)
raster_accum_gathered_kernel(const float* __restrict__ rows, int n_tris,
                             const int* __restrict__ bins, const int* __restrict__ counts,
                             int bin_width, int tiles_x, const float* __restrict__ z_base,
                             const float* __restrict__ light, float* __restrict__ acc_out,
                             int* __restrict__ cnt_out, int hp, int wp) {
  __shared__ float scoef[BATCH * ACCUM_COLS];
  __shared__ int sid[BATCH];
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x;
  const int col = threadIdx.x % TILE_W;
  const float x = static_cast<float>(tx * TILE_W + col) + 0.5f;
  // light: [sun_dir xyz (baked into the light numerator at setup), power,
  // ambient rgb, 0]
  const float power = light[3];
  const float amb[3] = {light[4], light[5], light[6]};

  float y[PIX], zb[PIX], acc[3][PIX];
  int cnt[PIX];
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const size_t p = static_cast<size_t>(pixel_row(ty, i)) * wp + tx * TILE_W + col;
    y[i] = static_cast<float>(pixel_row(ty, i)) + 0.5f;
    zb[i] = z_base[p];
    acc[0][i] = acc[1][i] = acc[2][i] = 0.0f;
    cnt[i] = 0;
  }

  const int n = min(counts[tile], bin_width);
  const int* tbins = bins + static_cast<size_t>(tile) * bin_width;
  for (int base = 0; base < n; base += BATCH) {
    __syncthreads();
    stage_entries<ACCUM_COLS>(scoef, sid, rows, n_tris, tbins, base, n);
    __syncthreads();
    const int m = min(BATCH, n - base);
#pragma unroll 1
    for (int j = 0; j < m; ++j) {   // slot order: the order of the sum
      if (sid[j] < 0) continue;     // uniform across the block
      const float* r = scoef + j * ACCUM_COLS;
      Tri tri;
      tri.load(r);
#pragma unroll
      for (int i = 0; i < PIX; ++i) {
        float zv;
        if (!(tri.covers(x, y[i], &zv) && zv >= 0.0f && zv >= zb[i])) continue;
        add_fragment(r + ACCUM_NUM, ACCUM_NUM_STRIDE, r + ACCUM_DEN, x, y[i], power, amb,
                     &acc[0][i], &acc[1][i], &acc[2][i]);
        cnt[i] += 1;
      }
    }
  }

  const size_t plane_stride = static_cast<size_t>(hp) * wp;
#pragma unroll
  for (int i = 0; i < PIX; ++i) {
    const size_t p = static_cast<size_t>(pixel_row(ty, i)) * wp + tx * TILE_W + col;
#pragma unroll
    for (int c = 0; c < 3; ++c) acc_out[c * plane_stride + p] = acc[c][i];
    cnt_out[p] = cnt[i];
  }
}

__global__ void __launch_bounds__(THREADS)
raster_peel_gathered_kernel(const float* __restrict__ rows, int n_tris,
                            const int* __restrict__ bins, const int* __restrict__ counts,
                            int bin_width, int tiles_x, const float* __restrict__ z_base,
                            const int* __restrict__ last, int* __restrict__ best_out,
                            float* __restrict__ nums_out, float* __restrict__ metas_out,
                            int hp, int wp) {
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
  // every live slot is walked: the smallest eligible id may sit anywhere
  for (int base = 0; base < n; base += BATCH) {
    __syncthreads();
    stage_entries<PLANE_COLS>(scoef, sid, rows, n_tris, tbins, base, n);
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

extern "C" int raster_fused_gathered_launch(const float* rows, int n_tris, const int* bins,
                                            const int* counts, int bin_width, int tiles_x,
                                            int tiles_y, float* z, int* tid, float* nums,
                                            float* metas, void* stream) {
  return launch_vis(raster_fused_gathered_kernel, tiles_x * tiles_y, stream, rows, n_tris, bins,
                    counts, bin_width, tiles_x, z, tid, nums, metas, tiles_y * TILE_H,
                    tiles_x * TILE_W);
}

extern "C" int raster_accum_gathered_launch(const float* rows, int n_tris, const int* bins,
                                            const int* counts, int bin_width, int tiles_x,
                                            int tiles_y, const float* z_base,
                                            const float* light, float* acc, int* cnt,
                                            void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  raster_accum_gathered_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, n_tris, bins, counts, bin_width, tiles_x, z_base, light, acc, cnt,
      tiles_y * TILE_H, tiles_x * TILE_W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int raster_peel_gathered_launch(const float* rows, int n_tris, const int* bins,
                                           const int* counts, int bin_width, int tiles_x,
                                           int tiles_y, const float* z_base, const int* last,
                                           int* best, float* nums, float* metas,
                                           void* stream) {
  const int n_tiles = tiles_x * tiles_y;
  raster_peel_gathered_kernel<<<n_tiles, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      rows, n_tris, bins, counts, bin_width, tiles_x, z_base, last, best, nums, metas,
      tiles_y * TILE_H, tiles_x * TILE_W);
  return static_cast<int>(cudaGetLastError());
}
