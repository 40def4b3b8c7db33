// Shared pieces of the raster kernels (raster_fused.cu, raster_accum.cu,
// raster_peel.cu, raster_deferred.cu, raster_gathered.cu).
//
// Rounding is spelled out: every plane evaluation a*X + b*Y + c is
// fma(a, X, b*Y) + c with __fmaf_rn/__fmul_rn/__fadd_rn — the contraction
// XLA applies to the JAX reference on the CPU (measured) — and the library
// is built with -fmad=false, so nvcc contracts nothing else. The kernels
// then round exactly as the plain PyTorch versions (raster.fma) and the JAX
// reference do. The fill rule is the explicit (c > 0) | (c == 0 & top_left)
// form, which stays exact with fp32 subnormals (no -ftz).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <atomic>

namespace tr {

constexpr int ROW_COLS = 48;                           // fat-row width
// Binning constants of kernels/raster.py (CHUNK, GROUP, entry_shift): a bin
// entry is cid << ENTRY_SHIFT | gmask, one gmask bit per GROUP triangles.
constexpr int CHUNK = 32;
constexpr int GROUP = 8;
constexpr int N_GROUPS = CHUNK / GROUP;                // 4 gmask bits
constexpr int ENTRY_SHIFT = 4;
constexpr int GMASK_ALL = (1 << N_GROUPS) - 1;
static_assert(N_GROUPS <= 4, "ENTRY_SHIFT holds at most 4 gmask bits");
constexpr int ID_INF = 0x7FFFFFF;   // the peels' "no fragment" marker
constexpr int N_NUMS = 4;           // numerator planes: light_num, r, g, b
constexpr int N_METAS = 15;         // constant planes (META_COLS)
constexpr int REGION_W = 32;        // a warp's pixels: 32 columns
constexpr int REGION_H = 8;         //   x 8 rows, one column a lane

// A block's warps at most: 512 threads, which __launch_bounds__(T::THREADS,
// 2) holds to 64 registers a thread.
constexpr int MAX_WARPS = 16;

// The largest divisor of n that is at most cap.
constexpr int largest_divisor(int n, int cap) {
  int d = cap < n ? cap : n;
  while (n % d != 0) --d;
  return d;
}

// The raster tile, H x W pixels: whole 32x8 warp regions. Every raster
// kernel is a template on it. A block is WARPS warps, a warp a region at a
// time. A tile of at most MAX_WARPS regions (4,096 pixels: every tile of
// kernels/raster.py TILES) is one pass, a warp its region: each kernel's
// one-pass form, the code the shipped tiles were built with. A larger one
// is walked in PASSES passes of WARPS regions (region q = pass * WARPS +
// warp, WARPS the largest divisor of the regions up to MAX_WARPS, so that
// every pass is whole) by each kernel's *_passes form: each pass walks the
// tile's entries again, so a thread holds one region's pixels at a time,
// and the tile's merge buffer lives in dynamic shared memory beside the
// walk's buffer (past the 48 KB of static shared memory).
template <int TH, int TW>
struct Tile {
  static constexpr int H = TH;
  static constexpr int W = TW;
  static constexpr int PIX = H * W;
  static constexpr int REGIONS_X = W / REGION_W;   // regions across a tile
  static constexpr int REGIONS = REGIONS_X * (H / REGION_H);
  static constexpr int WARPS = largest_divisor(REGIONS, MAX_WARPS);
  static constexpr int THREADS = WARPS * 32;
  static constexpr int PASSES = REGIONS / WARPS;
  static_assert(W % REGION_W == 0 && H % REGION_H == 0, "regions tile a tile");
};

// Region q of a tile: its first column and row in the tile.
template <class T>
__device__ __forceinline__ int region_x0(int q) {
  return (q % T::REGIONS_X) * REGION_W;
}
template <class T>
__device__ __forceinline__ int region_y0(int q) {
  return (q / T::REGIONS_X) * REGION_H;
}

// Pixel j * T::THREADS + threadIdx.x of block `rank`'s 1/split of a
// tile's pixels (pixel (r, c) at r * T::W + c): the pixels a block merges
// and stores after the walk, T::PASSES a thread.
template <class T, int SPLIT>
__device__ __forceinline__ int merged_pixel(int rank, int j) {
  static_assert(T::PIX == SPLIT * T::THREADS * T::PASSES, "PASSES pixels a thread");
  return rank * (T::PIX / SPLIT) + j * T::THREADS + static_cast<int>(threadIdx.x);
}

// launch(Tile<H, W>{}) for the tile tile_h x tile_w; cudaErrorInvalidValue
// for any other. The main library holds every tile of kernels/raster.py
// TILES; a library built for one tile (kernels/_build.py build_tile, with
// -DTR_TILE_H and -DTR_TILE_W) holds that tile alone. Which tiles may be
// built is raster.tile_rule's question: the shared memory of every block
// within the 227 KB an H100 block can opt into. Whether its clusters can be
// scheduled is the card's: each kernel's raster_*_setup runs prepare_launch
// when a tile's library is loaded, before any launch.
template <typename Launch>
int with_tile(int tile_h, int tile_w, Launch&& launch) {
#if defined(TR_TILE_H) && defined(TR_TILE_W)
  if (tile_h == TR_TILE_H && tile_w == TR_TILE_W) return launch(Tile<TR_TILE_H, TR_TILE_W>{});
#else
  if (tile_h == 32 && tile_w == 128) return launch(Tile<32, 128>{});
  if (tile_h == 32 && tile_w == 64) return launch(Tile<32, 64>{});
  if (tile_h == 16 && tile_w == 128) return launch(Tile<16, 128>{});
  if (tile_h == 16 && tile_w == 64) return launch(Tile<16, 64>{});
  if (tile_h == 8 && tile_w == 128) return launch(Tile<8, 128>{});
  if (tile_h == 8 && tile_w == 64) return launch(Tile<8, 64>{});
#endif
  return static_cast<int>(cudaErrorInvalidValue);
}

// Shared memory a block has without opting in.
constexpr int STATIC_SMEM_BYTES = 48 * 1024;

// The dynamic shared memory of a block of a *_passes kernel, which its
// launch sizes: the kernel's buffers side by side, 16-B aligned.
__device__ __forceinline__ float* dynamic_smem() {
  extern __shared__ __align__(16) float tr_dynamic_smem[];
  return tr_dynamic_smem;
}

// The devices a *_passes kernel instance was set up on, a bit a device
// (prepare_launch).
struct Prepared {
  std::atomic<unsigned long long> devices{0};
};

// cudaOccupancyMaxActiveClusters of this library's *_passes instance of
// kernel 2.k (slot k) as prepare_launch last found it; 0 where none was
// set up (a tile of one pass, or no setup yet). raster_max_clusters
// reads it.
inline std::atomic<int> max_clusters[9];

// Set up a *_passes kernel instance, once a device, for blocks of
// `threads` threads with `bytes` of dynamic shared memory in clusters of
// `cluster`: the opt-in to `bytes` where that is above the 48 KB a block
// has without it, then cudaOccupancyMaxActiveClusters, which must find
// room for a cluster (cudaErrorInvalidConfiguration where it finds none:
// nothing launches), kept in max_clusters[slot]. Returns the CUDA error.
template <typename Kernel>
int prepare_launch(Prepared& ready, Kernel kernel, int threads, int bytes, int cluster,
                   int slot) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned long long bit = 1ull << (dev % 64);
  if (ready.devices.load() & bit) return 0;
  if (bytes > STATIC_SMEM_BYTES) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  max_clusters[slot].store(clusters);
  if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  ready.devices.fetch_or(bit);
  return 0;
}

// The shared memory a block of `kernel` takes, into *bytes: its static
// shared memory as the compiler laid it out (cudaFuncGetAttributes) and
// `dynamic`. Each kernel's raster_*_setup entry reports it, which
// kernels/raster.py's tile_smem must equal. Returns the CUDA error.
template <typename Kernel>
int block_smem(Kernel kernel, int dynamic, int* bytes) {
  cudaFuncAttributes attr = {};
  const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *bytes = static_cast<int>(attr.sharedSizeBytes) + dynamic;
  return 0;
}

__device__ __forceinline__ float plane(float a, float b, float c, float x,
                                       float y) {
  return __fadd_rn(__fmaf_rn(a, x, __fmul_rn(b, y)), c);
}

__device__ __forceinline__ bool top_left(float a, float b) {
  return (a > 0.0f) || (a == 0.0f && b > 0.0f);
}

__device__ __forceinline__ bool edge_cov(float a, float b, float c, bool tl,
                                         float x, float y) {
  const float v = plane(a, b, c, x, y);
  return (v > 0.0f) || (v == 0.0f && tl);
}

// Coverage of triangle row r at pixel (x, y), with its depth in *zv.
struct Tri {
  float e[12];
  bool tl0, tl1, tl2;

  __device__ __forceinline__ void load(const float* r) {
#pragma unroll
    for (int k = 0; k < 12; ++k) e[k] = r[k];
    tl0 = top_left(e[0], e[1]);
    tl1 = top_left(e[3], e[4]);
    tl2 = top_left(e[6], e[7]);
  }

  __device__ __forceinline__ bool covers(float x, float y, float* zv) const {
    *zv = plane(e[9], e[10], e[11], x, y);
    return edge_cov(e[0], e[1], e[2], tl0, x, y) &&
           edge_cov(e[3], e[4], e[5], tl1, x, y) &&
           edge_cov(e[6], e[7], e[8], tl2, x, y) && (*zv <= 1.0f);
  }
};

// META_COLS of kernels/raster.py: C_TEX x6 (31-36), C_GRAD x6 (37-42),
// den_c (43), nu_c (29), nv_c (30).
__device__ __forceinline__ int meta_col(int m) { return m < 13 ? 31 + m : 16 + m; }

// The epilogue of the fused raster and the fused peel: the winning
// triangle's numerator planes at the pixel center and its constant planes,
// read once from its fat row; zeros where no triangle won (id < 0).
__device__ __forceinline__ void store_winner(const float* __restrict__ rows, int id,
                                             float x, float y, size_t p,
                                             size_t plane_stride,
                                             float* __restrict__ nums_out,
                                             float* __restrict__ metas_out) {
  if (id >= 0) {
    const float* w = rows + static_cast<size_t>(id) * ROW_COLS;
#pragma unroll
    for (int a = 0; a < N_NUMS; ++a)
      nums_out[a * plane_stride + p] = plane(w[13 + a], w[19 + a], w[25 + a], x, y);
#pragma unroll
    for (int m = 0; m < N_METAS; ++m) metas_out[m * plane_stride + p] = w[meta_col(m)];
  } else {
#pragma unroll
    for (int a = 0; a < N_NUMS; ++a) nums_out[a * plane_stride + p] = 0.0f;
#pragma unroll
    for (int m = 0; m < N_METAS; ++m) metas_out[m * plane_stride + p] = 0.0f;
  }
}

// One taken fragment of the untextured transparent sum (kernels 2.2 and
// 2.7): acc += rgb * (max(light, 0.1) * power + ambient) (mesh.frag:12-18),
// with the reference's two contractions. num holds the 4 numerator planes
// [light, r, g, b]: plane a's (A, B, C) at num[a], num[stride + a],
// num[2 * stride + a]; den the denominator's (A, B, C). Nothing is carried
// between fragments but the sums.
__device__ __forceinline__ void add_fragment(const float* num, int stride,
                                             const float* den3, float x, float y,
                                             float power, const float* amb, float* ar,
                                             float* ag, float* ab) {
  const float den = plane(den3[0], den3[1], den3[2], x, y);
  const float inv = den != 0.0f ? __fdiv_rn(1.0f, den) : 0.0f;
  const float ln = __fmul_rn(plane(num[0], num[stride], num[2 * stride], x, y), inv);
  // jnp.maximum / torch.maximum propagate NaN; fmaxf would not
  const float lit = ln != ln ? ln : fmaxf(ln, 0.1f);
  const float cr = __fmul_rn(plane(num[1], num[stride + 1], num[2 * stride + 1], x, y), inv);
  const float cg = __fmul_rn(plane(num[2], num[stride + 2], num[2 * stride + 2], x, y), inv);
  const float cb = __fmul_rn(plane(num[3], num[stride + 3], num[2 * stride + 3], x, y), inv);
  *ar = __fmaf_rn(cr, __fmaf_rn(lit, power, amb[0]), *ar);
  *ag = __fmaf_rn(cg, __fmaf_rn(lit, power, amb[1]), *ag);
  *ab = __fmaf_rn(cb, __fmaf_rn(lit, power, amb[2]), *ab);
}

// ---------------------------------------------------------------------------
// The walk of kernels 2.1-2.3 and 2.7: a ring of staged chunks (2.7: of
// gathered slices), and the exact per-region reject.
// ---------------------------------------------------------------------------

constexpr int CHUNK_FLOATS = CHUNK * ROW_COLS;   // 6,144 B of fat rows
constexpr int AHEAD = 2;                         // chunks copied ahead of the raster
constexpr int RING_SLOTS = AHEAD + 2;            // shared-memory chunk slots
constexpr unsigned FULL_WARP = 0xFFFFFFFFu;
static_assert(CHUNK == 32, "one lane tests one triangle of a chunk for its warp");

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of chunk cid's fat rows into a ring slot, 16 B a piece
// over NTHREADS threads (the wrapper checks that rows is 16-B aligned).
template <int NTHREADS>
__device__ __forceinline__ void stage_chunk_async(float* slot, const float* rows, int cid) {
  const float4* src = reinterpret_cast<const float4*>(rows + static_cast<size_t>(cid) * CHUNK_FLOATS);
  float4* dst = reinterpret_cast<float4*>(slot);
  for (int k = threadIdx.x; k < CHUNK_FLOATS / 4; k += NTHREADS) cp_async16(dst + k, src + k);
}

// Entry e of a tile's bin: false for an entry the walk skips (a chunk id
// that is no chunk of rows, or no live group).
__device__ __forceinline__ bool bin_entry(const int* tbins, int e, int n_chunks, int* cid,
                                          int* gmask) {
  const int entry = tbins[e];
  *cid = entry >> ENTRY_SHIFT;
  *gmask = entry & GMASK_ALL;
  return *cid >= 0 && *cid < n_chunks && *gmask != 0;
}

// The walk's barrier before each entry. With a stop predicate (the peels)
// it is __syncthreads_and of every thread's stop(): the walk ends there
// when all of them may stop.
struct NoStop {};
__device__ __forceinline__ bool entry_barrier(NoStop) {
  __syncthreads();
  return false;
}
template <typename Stop>
__device__ __forceinline__ bool entry_barrier(Stop& stop) {
  return __syncthreads_and(stop()) != 0;
}

// Walk units [0, n) through the ring in order: stage(slot, k) starts the
// copies (cp.async) of unit k's rows into a slot, body(slot, k) runs once
// all NTHREADS threads of the block see them. The copies run AHEAD units
// ahead of the raster; with AHEAD + 2 slots one barrier a unit keeps a
// slot from being refilled before every thread is done with it. With a
// stop predicate the walk ends at the first unit's barrier where stop()
// holds in every thread; the copies in flight are waited for either way
// before the ring is handed back. Every thread of the block must call this
// with the same arguments.
template <int NTHREADS, typename Stage, typename Body, typename Stop = NoStop>
__device__ __forceinline__ void walk_ring(int n, float* ring, Stage&& stage, Body&& body,
                                          Stop stop = Stop{}) {
#pragma unroll
  for (int d = 0; d < AHEAD; ++d) {
    if (d < n) stage(ring + d * CHUNK_FLOATS, d);
    cp_async_commit();
  }
  for (int k = 0; k < n; ++k) {
    // slot (k + AHEAD) % RING_SLOTS was last read at unit k - 2: every
    // thread passed unit k - 1's barrier after it
    if (k + AHEAD < n) stage(ring + ((k + AHEAD) % RING_SLOTS) * CHUNK_FLOATS, k + AHEAD);
    cp_async_commit();
    cp_async_wait<AHEAD>();   // this thread's copies of unit k have landed
    if (entry_barrier(stop)) break;   // and every other thread's
    body(ring + (k % RING_SLOTS) * CHUNK_FLOATS, k);
  }
  cp_async_wait<0>();
  __syncthreads();            // the ring is free for other use
}

// Walk the entries [e0, e1) of a tile's chunk bin in order (walk_ring, a
// unit an entry), calling body(slot, cid, gmask) on each live chunk.
template <int NTHREADS, typename Body, typename Stop = NoStop>
__device__ __forceinline__ void walk_entries(const float* rows, const int* tbins, int e0,
                                             int e1, int n_chunks, float* ring, Body&& body,
                                             Stop stop = Stop{}) {
  walk_ring<NTHREADS>(
      e1 - e0, ring,
      [&](float* slot, int k) {
        int cid, gmask;
        if (bin_entry(tbins, e0 + k, n_chunks, &cid, &gmask))
          stage_chunk_async<NTHREADS>(slot, rows, cid);
      },
      [&](const float* slot, int k) {
        int cid, gmask;
        if (bin_entry(tbins, e0 + k, n_chunks, &cid, &gmask)) body(slot, cid, gmask);
      },
      stop);
}

// Entry e of a tile's per-triangle bin of n entries: its id if it is a row
// of a table of n_tris rows, else -1 (past the count, a -1 hole, or no row
// of the table: the walks skip it).
__device__ __forceinline__ int tri_entry(const int* tbins, int e, int n, int n_tris) {
  const int id = e < n ? tbins[e] : -1;
  return id >= 0 && id < n_tris ? id : -1;
}

// Start the copy of a slice of a tile's per-triangle bin into a ring slot:
// the fat row of entry base + t at row t of the slot (t < CHUNK), 16 B a
// piece over NTHREADS threads. An entry that is no row (tri_entry) is not
// copied: its row of the slot holds stale data and must not be read.
template <int NTHREADS>
__device__ __forceinline__ void stage_slice_async(float* slot, const float* rows, int n_tris,
                                                  const int* tbins, int base, int n) {
  constexpr int PIECES = ROW_COLS / 4;   // 16 B pieces a row
  for (int k = threadIdx.x; k < CHUNK * PIECES; k += NTHREADS) {
    const int t = k / PIECES;
    const int id = tri_entry(tbins, base + t, n, n_tris);
    if (id >= 0)
      cp_async16(slot + t * ROW_COLS + (k % PIECES) * 4,
                 rows + static_cast<size_t>(id) * ROW_COLS + (k % PIECES) * 4);
  }
}

// The band of the frame a launch of 2.1-2.5 covers: tiles_y tile rows
// from the frame's tile row tile_y0, pixel rows from y0 = tile_y0 * T::H
// (0 and the whole frame for a frame on one device, and for 2.6-2.8). The
// kernels count pixel rows in the frame, so every pixel center (y + 0.5)
// is the frame's and each output is the same float arithmetic as a launch
// over the whole frame; the planes a launch reads and writes hold the
// band alone, frame row y at their row y - y0, wp columns a row.
struct Band {
  int y0, wp;

  __device__ __forceinline__ size_t at(int row, int col) const {
    return static_cast<size_t>(row - y0) * wp + col;
  }
};

// A warp's pixel region: REGION_W columns by REGION_H rows from pixel (x0,
// y0); centers x in [x0 + 0.5, x0 + REGION_W - 0.5], row r at y0 + r + 0.5.
struct Region {
  double xc, hw, y0c, xa, ya;   // x center and half extent, row 0's y, largest |x| / |y|

  __device__ Region(int x0, int y0)
      : xc(x0 + 0.5 * REGION_W), hw(0.5 * (REGION_W - 1)), y0c(y0 + 0.5),
        xa(x0 + REGION_W - 0.5), ya(y0 + REGION_H - 0.5) {}
};

constexpr unsigned ALL_ROWS = (1u << REGION_H) - 1;

// The rows of the region where edge plane (a, b, c) may be >= 0 as the
// kernels evaluate it (one bit a row); on a row whose bit is 0 it is
// negative at every pixel center, so no pixel there is covered. The float
// value v = fl(fl(fma(a, x, fl(b*y))) + c) differs from the exact
// a*x + b*y + c by at most 3 u (|a x| + |b y| + |c|) + 3 * 2^-150 (three
// roundings, u = 2^-24, the last term for subnormal results), below
// M = mag * 2^-21 + 2^-140 with mag = |a| max|x| + |b| max|y| + |c| over
// the region. In double, the exact maximum over a row's centers,
// a xc + |a| hw + b y + c, is computed to within ~2^-50 of mag, so
// max + M < 0 proves v < 0 at every center of the row, -0.0 and the
// top-left rule's v == 0 included. mag < 2^100 keeps every float step
// finite; NaN and infinite coefficients fail it and reject no row.
__device__ __forceinline__ unsigned edge_rows(float a, float b, float c, const Region& g) {
  const double da = a, db = b, dc = c;
  const double mag = fabs(da) * g.xa + fabs(db) * g.ya + fabs(dc);
  if (!(mag < 0x1p100)) return ALL_ROWS;
  const double top = da * g.xc + fabs(da) * g.hw + dc + (mag * 0x1p-21 + 0x1p-140);
  unsigned rows = 0;
#pragma unroll
  for (int r = 0; r < REGION_H; ++r)
    if (!(top + db * (g.y0c + r) < 0.0)) rows |= 1u << r;
  return rows;
}

// The region's rows triangle row r may cover; 0 is exact (it covers no
// pixel of the region), a set bit may be wrong and the per-pixel test
// decides.
__device__ __forceinline__ unsigned cover_rows(const float* r, const Region& g) {
  return edge_rows(r[0], r[1], r[2], g) & edge_rows(r[3], r[4], r[5], g) &
         edge_rows(r[6], r[7], r[8], g);
}

// Lane t's triangle of the chunk, for its warp's region: the rows it may
// cover (0 if its gmask group is dead). The chunk's triangles to test are
// __ballot_sync(FULL_WARP, rows != 0); triangle t's rows reach every lane
// through __shfl_sync(FULL_WARP, rows, t).
__device__ __forceinline__ unsigned lane_rows(const float* slot, int gmask, const Region& g) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  return ((gmask >> (lane / GROUP)) & 1) ? cover_rows(slot + lane * ROW_COLS, g) : 0u;
}

// ---------------------------------------------------------------------------
// The sums 2.2 and 2.7: a tile's pixels split among blocks (2.2: column
// strips; 2.7: 32x8 regions), each walking the tile's whole entry list in
// order.
// ---------------------------------------------------------------------------

// A thread's 8 pixels of a sum: one column (its lane) of its warp's 32x8
// region, with the opaque depth, the three sums and the count in
// registers. NONNEG_Z adds zv >= 0 to the take (kernel 2.7's rule; for 2.2
// it is subsumed by zv >= z_base, the opaque depth, itself >= 0).
template <bool NONNEG_Z>
struct AccumPixels {
  float x;                 // the column's pixel center
  int px, py0;             // the column and the region's first row in the frame
  Band band;
  float power, amb[3];     // light: sun power, ambient rgb
  float zb[REGION_H], acc[3][REGION_H];
  int cnt[REGION_H];

  // light: [sun_dir xyz (baked into the light numerator at setup), power,
  // ambient rgb, 0]
  __device__ __forceinline__ void load(const float* __restrict__ z_base,
                                       const float* __restrict__ light, int col, int py,
                                       const Band& b) {
    px = col;
    py0 = py;
    band = b;
    x = static_cast<float>(px) + 0.5f;
    power = light[3];
    amb[0] = light[4];
    amb[1] = light[5];
    amb[2] = light[6];
#pragma unroll
    for (int i = 0; i < REGION_H; ++i) {
      zb[i] = z_base[band.at(py0 + i, px)];
      acc[0][i] = acc[1][i] = acc[2][i] = 0.0f;
      cnt[i] = 0;
    }
  }

  // One slice of 32 fat rows in shared memory, lane t's triangle at
  // slot + t * ROW_COLS and `live` in lane t where that row is one to
  // take: lane t tests its triangle against the warp's region
  // (cover_rows); the warp takes the ballot's triangles in lane order, on
  // only the rows they may cover, and adds each fragment taken
  // (add_fragment). The rows skipped cover no pixel of the region, so each
  // pixel's sequence of adds is the plain walk's.
  __device__ __forceinline__ void add_slice(const float* slot, bool live, const Region& g) {
    const int lane = static_cast<int>(threadIdx.x) % 32;
    const unsigned rows_of = live ? cover_rows(slot + lane * ROW_COLS, g) : 0u;
    unsigned m = __ballot_sync(FULL_WARP, rows_of != 0);
    while (m) {
      const int t = __ffs(m) - 1;
      m &= m - 1;
      const unsigned rows_t = __shfl_sync(FULL_WARP, rows_of, t);
      const float* r = slot + t * ROW_COLS;
      Tri tri;
      tri.load(r);
#pragma unroll
      for (int i = 0; i < REGION_H; ++i) {
        if (!((rows_t >> i) & 1)) continue;   // uniform across the warp
        const float y = static_cast<float>(py0 + i) + 0.5f;
        float zv;
        if (!(tri.covers(x, y, &zv) && (!NONNEG_Z || zv >= 0.0f) && zv >= zb[i])) continue;
        // numerators in columns 13-16 / 19-22 / 25-28, den in 41-43
        add_fragment(r + 13, 6, r + 41, x, y, power, amb, &acc[0][i], &acc[1][i],
                     &acc[2][i]);
        cnt[i] += 1;
      }
    }
  }

  __device__ __forceinline__ void store(float* __restrict__ acc_out, int* __restrict__ cnt_out,
                                        size_t plane_stride) const {
#pragma unroll
    for (int i = 0; i < REGION_H; ++i) {
      const size_t p = band.at(py0 + i, px);
#pragma unroll
      for (int c = 0; c < 3; ++c) acc_out[c * plane_stride + p] = acc[c][i];
      cnt_out[p] = cnt[i];
    }
  }
};

// ---------------------------------------------------------------------------
// The peels 2.3, 2.5 and 2.8: a tile's entries split over a thread-block
// cluster, merged by a min.
// ---------------------------------------------------------------------------

constexpr int PEEL_SPLIT = 8;   // blocks a tile: the cluster (portable maximum)

// Entries [*e0, *e1) of segment `rank` of a tile's n entries: one segment
// for every seg_min entries, at least 1 and at most split (segment q of s
// covers [n q / s, n (q + 1) / s), raster.segment_bounds); an empty range
// for a block past the segments. Returns the number of segments.
__device__ __forceinline__ int tile_segment(int n, int split, int seg_min, int rank, int* e0,
                                            int* e1) {
  const int segs = min(split, max(1, (n + seg_min - 1) / seg_min));
  *e0 = rank < segs ? static_cast<int>(static_cast<long long>(n) * rank / segs) : 0;
  *e1 = rank < segs ? static_cast<int>(static_cast<long long>(n) * (rank + 1) / segs) : 0;
  return segs;
}

// Do the keys of bin entries [e0, e1) strictly ascend (key = entry >>
// shift: the chunk id of a dense entry, the id itself of a triangle
// entry)? Then a pixel that holds a layer in this segment keeps it: every
// later triangle's id is larger. Block-wide over NTHREADS threads; every
// thread must call it.
template <int NTHREADS>
__device__ __forceinline__ bool keys_ascend(const int* tbins, int e0, int e1, int shift) {
  int asc = 1;
  for (int e = e0 + static_cast<int>(threadIdx.x); e + 1 < e1; e += NTHREADS)
    asc &= (tbins[e] >> shift) < (tbins[e + 1] >> shift);
  return __syncthreads_and(asc) != 0;
}

// A thread's 8 pixels of a peel: one column (its lane) of its warp's 32x8
// region, with the opaque depth, the previous layer and the best id so
// far. NONNEG_Z adds zv >= 0 to the take (kernels 2.5 and 2.8; for 2.3 it
// is subsumed by zv >= z_base, the opaque depth, itself >= 0).
template <bool NONNEG_Z>
struct PeelPixels {
  float x;                 // the column's pixel center
  int py0;                 // the region's first row in the frame
  float zb[REGION_H];
  int lt[REGION_H], best[REGION_H];
  int lt_min;              // the smallest `last` of the warp's 256 pixels
  int max_id;              // the largest id a bin may hold
  bool ascending;          // the segment's ids ascend (keys_ascend)

  __device__ __forceinline__ void load(const float* __restrict__ z_base,
                                       const int* __restrict__ last, int px, int py,
                                       const Band& band, int largest_id) {
    x = static_cast<float>(px) + 0.5f;
    py0 = py;
    max_id = largest_id;
    lt_min = 0x7FFFFFFF;
#pragma unroll
    for (int i = 0; i < REGION_H; ++i) {
      const size_t p = band.at(py + i, px);
      zb[i] = z_base[p];
      lt[i] = last[p];
      best[i] = ID_INF;
      lt_min = min(lt_min, lt[i]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lt_min = min(lt_min, __shfl_xor_sync(FULL_WARP, lt_min, off));
  }

  // Can no later entry of the segment change any of this thread's pixels?
  // A pixel is settled when it holds a layer and the ids ascend, or when
  // no id of the table is larger than its `last`.
  __device__ __forceinline__ bool settled() const {
    bool done = true;
#pragma unroll
    for (int i = 0; i < REGION_H; ++i)
      done &= (ascending && best[i] < ID_INF) || lt[i] >= max_id;
    return done;
  }

  // The take of triangle `id` on the region rows set in rows_t (a uniform
  // bit per row across the warp): the smallest id > last that covers the
  // pixel and passes the depth test.
  __device__ __forceinline__ void take(const Tri& tri, int id, unsigned rows_t) {
#pragma unroll
    for (int i = 0; i < REGION_H; ++i) {
      if (!((rows_t >> i) & 1)) continue;
      float zv;
      if (id > lt[i] && id < best[i] &&
          tri.covers(x, static_cast<float>(py0 + i) + 0.5f, &zv) &&
          (!NONNEG_Z || zv >= 0.0f) && zv >= zb[i])
        best[i] = id;
    }
  }
};

// The merge: each block of the cluster that walked a segment puts its best
// ids (the tile's T::PIX pixels, pixel (r, c) at r * T::W + c) in buf, in
// its own shared memory; then every block takes, for its 1/PEEL_SPLIT of
// the tile's pixels (one a thread), the min over the segs segments
// through distributed shared memory. A min has no order, and each
// segment's best is the min of its own entries, so the result is the
// whole walk's. Returns the merged id of pixel rank * T::THREADS +
// threadIdx.x; no block leaves while another may read its buf.
template <class T, bool NONNEG_Z>
__device__ __forceinline__ int merge_min(cooperative_groups::cluster_group& cluster, int* buf,
                                         const PeelPixels<NONNEG_Z>& s, int rx0, int ry0,
                                         int rank, int segs) {
  static_assert(T::PIX == PEEL_SPLIT * T::THREADS, "the merge gives each thread one pixel");
  if (rank < segs) {
    const int lane = static_cast<int>(threadIdx.x) % 32;
#pragma unroll
    for (int i = 0; i < REGION_H; ++i) buf[(ry0 + i) * T::W + rx0 + lane] = s.best[i];
  }
  cluster.sync();
  const int p = rank * T::THREADS + static_cast<int>(threadIdx.x);
  int best = ID_INF;
  for (int q = 0; q < segs; ++q) best = min(best, cluster.map_shared_rank(buf, q)[p]);
  cluster.sync();
  return best;
}

// merge_min for a tile of several passes, in two steps. park_best, after
// each pass: a block that walked a segment puts its best ids of region
// (rx0, ry0) in buf, as merge_min does the tile's. merge_min_passes, after
// the last pass: each block takes the min over the segments for its
// 1/PEEL_SPLIT of the tile's pixels, T::PASSES a thread (merged_pixel);
// best[j] is pixel merged_pixel(rank, j)'s. No block leaves while another
// may read its buf.
template <class T, bool NONNEG_Z>
__device__ __forceinline__ void park_best(int* buf, const PeelPixels<NONNEG_Z>& s, int rx0,
                                          int ry0, int rank, int segs) {
  if (rank < segs) {
    const int lane = static_cast<int>(threadIdx.x) % 32;
#pragma unroll
    for (int i = 0; i < REGION_H; ++i) buf[(ry0 + i) * T::W + rx0 + lane] = s.best[i];
  }
}

template <class T>
__device__ __forceinline__ void merge_min_passes(cooperative_groups::cluster_group& cluster,
                                                 int* buf, int rank, int segs,
                                                 int (&best)[T::PASSES]) {
  cluster.sync();
#pragma unroll
  for (int j = 0; j < T::PASSES; ++j) {
    const int p = merged_pixel<T, PEEL_SPLIT>(rank, j);
    best[j] = ID_INF;
    for (int q = 0; q < segs; ++q) best[j] = min(best[j], cluster.map_shared_rank(buf, q)[p]);
  }
  cluster.sync();
}

// The epilogue of the peels 2.3 and 2.8 at pixel (row, col): the layer id
// (ID_INF: none) and its triangle's planes (store_winner; zeros where
// there is none).
__device__ __forceinline__ void store_layer(const float* __restrict__ rows, int best, int row,
                                            int col, const Band& band, size_t plane_stride,
                                            int* __restrict__ best_out,
                                            float* __restrict__ nums_out,
                                            float* __restrict__ metas_out) {
  const size_t gp = band.at(row, col);
  best_out[gp] = best;
  store_winner(rows, best < ID_INF ? best : -1, static_cast<float>(col) + 0.5f,
               static_cast<float>(row) + 0.5f, gp, plane_stride, nums_out, metas_out);
}

// ---------------------------------------------------------------------------
// The visibility walk of kernels 2.4 and 2.6 over per-triangle bins: a
// tile's entries split over a thread-block cluster, the segments' winners
// folded in walk order.
// ---------------------------------------------------------------------------

// A block is T::THREADS threads, a warp a 32x8 region of the tile, and
// stages T::THREADS entries a pass (one a thread); its fold takes
// T::PIX / VIS_SPLIT of the tile's pixels.
constexpr int VIS_SPLIT = 8;      // blocks a tile: the cluster (portable maximum)
constexpr int VIS_SEG_MIN = 32;   // a segment for every VIS_SEG_MIN entries
constexpr int PLANE_COLS = 12;               // edge and depth coefficients of a row
constexpr int COEF_STRIDE = PLANE_COLS + 1;  // lane t's row t: 32 distinct banks
constexpr int PORTABLE_CLUSTER = 8;

// Stage entries [base, base + blockDim.x) of a tile's bin, one a thread:
// sid the id (-1 at or past e1, or for an entry that is no row of the
// table) and scoef its 12 plane coefficients, COEF_STRIDE floats apart,
// from a table ROW_STRIDE floats a row (16: packed setup rows; 48: fat
// rows, whose first 12 columns are the same planes). The caller
// synchronises before and after.
template <int ROW_STRIDE>
__device__ __forceinline__ void stage_planes(float* scoef, int* sid,
                                             const float* __restrict__ table, int n_tris,
                                             const int* tbins, int base, int e1) {
  const int id = tri_entry(tbins, base + static_cast<int>(threadIdx.x), e1, n_tris);
  sid[threadIdx.x] = id;
  if (id >= 0) {
    const float* r = table + static_cast<size_t>(id) * ROW_STRIDE;
#pragma unroll
    for (int c = 0; c < PLANE_COLS; ++c) scoef[threadIdx.x * COEF_STRIDE + c] = r[c];
  }
}

// The (z, tid) of a thread's REGION_H pixels: one column (its lane) of its
// warp's region.
struct VisPixels {
  float z[REGION_H];
  int tid[REGION_H];
};

// Walk entries [e0, e1) of a tile's bin in order, from (DEPTH_CLEAR, -1):
// per pixel the reversed-Z (>=) winner with 0 <= z <= 1, a later entry
// winning an equal z. Lane t of each warp tests entry t of a 32-entry
// slice against the warp's region (cover_rows); the warp walks the entries
// its ballot keeps, in entry order, on the rows they may cover. Nothing
// ends a walk early. Every thread of the block (BATCH of them, one an
// entry of a staged batch) must call it.
template <int ROW_STRIDE, int BATCH>
__device__ __forceinline__ void vis_walk(const float* __restrict__ table, int n_tris,
                                         const int* tbins, int e0, int e1, const Region& g,
                                         float x, int py0, float* scoef, int* sid,
                                         VisPixels& s) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  for (int base = e0; base < e1; base += BATCH) {
    __syncthreads();   // the previous batch is consumed
    stage_planes<ROW_STRIDE>(scoef, sid, table, n_tris, tbins, base, e1);
    __syncthreads();
    const int m = min(BATCH, e1 - base);
    for (int j0 = 0; j0 < m; j0 += 32) {
      const int j = j0 + lane;
      const unsigned rows_of =
          j < m && sid[j] >= 0 ? cover_rows(scoef + j * COEF_STRIDE, g) : 0u;
      unsigned b = __ballot_sync(FULL_WARP, rows_of != 0);
      while (b) {
        const int t = __ffs(b) - 1;
        b &= b - 1;
        const unsigned rows_t = __shfl_sync(FULL_WARP, rows_of, t);
        Tri tri;
        tri.load(scoef + (j0 + t) * COEF_STRIDE);
        const int id = sid[j0 + t];
#pragma unroll
        for (int i = 0; i < REGION_H; ++i) {
          if (!((rows_t >> i) & 1)) continue;   // uniform across the warp
          float zv;
          // zv >= 0 is subsumed by zv >= z (z starts at +0.0)
          if (tri.covers(x, static_cast<float>(py0 + i) + 0.5f, &zv) && zv >= s.z[i]) {
            s.z[i] = zv;
            s.tid[i] = id;
          }
        }
      }
    }
  }
}

// A tile of kernel 2.4 or 2.6, one block of its cluster of VIS_SPLIT: the
// tile's n = clamp(count, 0, bin_width) entries cut into segments
// (tile_segment), this block's walked (vis_walk), and the segments'
// winners folded in segment order through distributed shared memory with
// the walk's own rule: take (zq, tq) if tq >= 0 and zq >= the running z.
// The launch covers `band` (Band): tile row ty of the launch is the
// frame's tile row ty + band.y0 / T::H, and rows are the frame's.
// The winner is the last entry in walk order with the largest z, so the
// fold is exact for bins in any order; the z carried is the winner's own,
// so -0.0 and +0.0 tie as >= ties them and the output keeps its bits, and
// a segment with no winner (tid -1) never beats one at z = 0. Then
// store(row, col, z, tid) for each of the block's 1/VIS_SPLIT of the
// tile's pixels. A tile of one segment is the first block's alone: no
// fold, no cluster barrier, store for all its pixels.
template <class T, int ROW_STRIDE, typename Store>
__device__ __forceinline__ void vis_tile(const float* __restrict__ table, int n_tris,
                                         const int* __restrict__ bins,
                                         const int* __restrict__ counts, int bin_width,
                                         int tiles_x, const Band& band, Store&& store) {
  constexpr int VIS_PIX = T::PIX / VIS_SPLIT;   // the fold's pixels a block
  static_assert(T::PIX % VIS_SPLIT == 0 && VIS_PIX <= T::THREADS,
                "the fold gives each thread at most one pixel");
  static_assert(T::THREADS * COEF_STRIDE <= 2 * T::PIX, "the batch fits the fold buffer");
  // the batch's planes, then the segment's (z, tid) for the fold
  __shared__ float smem[2 * T::PIX];
  __shared__ int sid[T::THREADS];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / VIS_SPLIT;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x + band.y0 / T::H;   // the frame's tile row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rx0 = (warp % T::REGIONS_X) * REGION_W;   // region in the tile
  const int ry0 = (warp / T::REGIONS_X) * REGION_H;
  const int px = tx * T::W + rx0 + lane;
  const int py0 = ty * T::H + ry0;
  // bins and counts come from the caller: never walk past the bin row
  const int n = max(0, min(counts[tile], bin_width));
  int e0, e1;
  const int segs = tile_segment(n, VIS_SPLIT, VIS_SEG_MIN, rank, &e0, &e1);
  if (segs == 1 && rank > 0) return;

  VisPixels s;
#pragma unroll
  for (int i = 0; i < REGION_H; ++i) {
    s.z[i] = 0.0f;   // DEPTH_CLEAR
    s.tid[i] = -1;
  }
  if (rank < segs)   // uniform across the block
    vis_walk<ROW_STRIDE, T::THREADS>(table, n_tris,
                                     bins + static_cast<size_t>(tile) * bin_width, e0, e1,
                                     Region(tx * T::W + rx0, py0),
                                     static_cast<float>(px) + 0.5f, py0, smem, sid, s);
  if (segs == 1) {
#pragma unroll
    for (int i = 0; i < REGION_H; ++i) store(py0 + i, px, s.z[i], s.tid[i]);
    return;
  }

  __syncthreads();   // the batch buffer is free for the fold
  float* zs = smem;
  int* ts = reinterpret_cast<int*>(smem + T::PIX);
  if (rank < segs) {
#pragma unroll
    for (int i = 0; i < REGION_H; ++i) {
      const int p = (ry0 + i) * T::W + rx0 + lane;
      zs[p] = s.z[i];
      ts[p] = s.tid[i];
    }
  }
  cluster.sync();
  const int p = rank * VIS_PIX + static_cast<int>(threadIdx.x);
  float zw = 0.0f;
  int tw = -1;
  if (threadIdx.x < VIS_PIX) {
    for (int q = 0; q < segs; ++q) {
      const float zq = cluster.map_shared_rank(zs, q)[p];
      const int tq = cluster.map_shared_rank(ts, q)[p];
      if (tq >= 0 && zq >= zw) {
        zw = zq;
        tw = tq;
      }
    }
  }
  cluster.sync();   // no block leaves while another reads its shared memory
  if (threadIdx.x < VIS_PIX) store(ty * T::H + p / T::W, tx * T::W + p % T::W, zw, tw);
}

// vis_tile_passes' dynamic shared memory, in floats: a batch's plane
// coefficients, the tile's (z, tid) for the fold (kept from pass to pass),
// then the batch's ids.
template <class T>
struct VisSmem {
  static constexpr int BATCH = T::THREADS * COEF_STRIDE;
  static constexpr int FOLD = 2 * T::PIX;
  static constexpr int BYTES = (BATCH + FOLD + T::THREADS) * 4;
};

// vis_tile for a tile of several passes: each pass's warps walk their
// regions over the block's segment (vis_walk), and park their (z, tid) in
// the fold buffer; after the last pass the fold and the stores run for
// the block's 1/VIS_SPLIT of the tile's pixels, T::PASSES a thread.
template <class T, int ROW_STRIDE, typename Store>
__device__ __forceinline__ void vis_tile_passes(const float* __restrict__ table, int n_tris,
                                                const int* __restrict__ bins,
                                                const int* __restrict__ counts, int bin_width,
                                                int tiles_x, const Band& band, Store&& store) {
  using S = VisSmem<T>;
  static_assert(T::PASSES > 1, "a tile of one pass takes vis_tile");
  float* scoef = dynamic_smem();
  float* zs = scoef + S::BATCH;
  int* ts = reinterpret_cast<int*>(zs + T::PIX);
  int* sid = reinterpret_cast<int*>(zs + S::FOLD);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / VIS_SPLIT;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x + band.y0 / T::H;   // the frame's tile row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // bins and counts come from the caller: never walk past the bin row
  const int n = max(0, min(counts[tile], bin_width));
  int e0, e1;
  const int segs = tile_segment(n, VIS_SPLIT, VIS_SEG_MIN, rank, &e0, &e1);
  if (segs == 1 && rank > 0) return;

  for (int pass = 0; pass < T::PASSES; ++pass) {
    const int q = pass * T::WARPS + warp;
    const int rx0 = region_x0<T>(q);   // region in the tile
    const int ry0 = region_y0<T>(q);
    const int px = tx * T::W + rx0 + lane;
    const int py0 = ty * T::H + ry0;
    VisPixels s;
#pragma unroll
    for (int i = 0; i < REGION_H; ++i) {
      s.z[i] = 0.0f;   // DEPTH_CLEAR
      s.tid[i] = -1;
    }
    if (rank < segs)   // uniform across the block
      vis_walk<ROW_STRIDE, T::THREADS>(table, n_tris,
                                       bins + static_cast<size_t>(tile) * bin_width, e0, e1,
                                       Region(tx * T::W + rx0, py0),
                                       static_cast<float>(px) + 0.5f, py0, scoef, sid, s);
    if (segs == 1) {
#pragma unroll
      for (int i = 0; i < REGION_H; ++i) store(py0 + i, px, s.z[i], s.tid[i]);
    } else if (rank < segs) {
#pragma unroll
      for (int i = 0; i < REGION_H; ++i) {
        const int p = (ry0 + i) * T::W + rx0 + lane;
        zs[p] = s.z[i];
        ts[p] = s.tid[i];
      }
    }
  }
  if (segs == 1) return;

  cluster.sync();
  float zw[T::PASSES];
  int tw[T::PASSES];
#pragma unroll
  for (int j = 0; j < T::PASSES; ++j) {
    const int p = merged_pixel<T, VIS_SPLIT>(rank, j);
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
#pragma unroll
  for (int j = 0; j < T::PASSES; ++j) {
    const int p = merged_pixel<T, VIS_SPLIT>(rank, j);
    store(ty * T::H + p / T::W, tx * T::W + p % T::W, zw[j], tw[j]);
  }
}

// ---------------------------------------------------------------------------
// The peel walk of kernels 2.5 and 2.8 over per-triangle bins.
// ---------------------------------------------------------------------------

constexpr int DEFERRED_SEG_MIN = 32;            // a segment for every 32 entries

// A warp's walk of entries [e0, e1) of a tile's per-triangle bin over its
// 32x8 region, into s (loaded with the region's opaque depth and `last`):
// the block stages the entries BATCH at a time (stage_planes into scoef
// and sid), lane t of each warp tests entry t of a 32-entry slice (its id
// past the region's smallest `last`, cover_rows), and the warp takes the
// entries its ballot keeps; the walk stops where every pixel is settled
// (keys_ascend says where a layer settles a pixel). Both forms of 2.5 and
// 2.8 walk a region with it. Every thread of the block (BATCH of them)
// must call it.
template <int ROW_STRIDE, int BATCH>
__device__ __forceinline__ void peel_walk(const float* __restrict__ table, int n_tris,
                                          const int* tbins, int e0, int e1,
                                          const Region& region, float* scoef, int* sid,
                                          PeelPixels<true>& s) {
  const int lane = threadIdx.x % 32;
  s.ascending = keys_ascend<BATCH>(tbins, e0, e1, 0);
  for (int base = e0; base < e1; base += BATCH) {
    // the barrier before restaging: the previous batch is consumed
    if (__syncthreads_and(s.settled())) break;   // every pixel of the block is settled
    stage_planes<ROW_STRIDE>(scoef, sid, table, n_tris, tbins, base, e1);
    __syncthreads();
    const int m = min(BATCH, e1 - base);
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

// A tile of kernel 2.5 or 2.8, one block of its cluster of PEEL_SPLIT: 2.3's
// design (raster_peel.cu) over per-triangle bins of a table ROW_STRIDE
// floats a row (16: packed setup rows; 48: fat rows). The tile's n =
// clamp(count, 0, bin_width) entries are cut into segments, one for every
// DEFERRED_SEG_MIN entries (tile_segment), a block each. Each block
// stages its segment's entries T::THREADS at a time (stage_planes:
// id and 12 plane coefficients a thread); lane t of each warp tests entry
// t of a 32-entry slice against its warp's region (cover_rows) and skips
// it where its id is <= the region's smallest `last`, and the warp walks
// the entries its ballot keeps, on the rows they may cover (PeelPixels<true>:
// 0 <= z and z >= z_base). The stops are 2.3's on the ids themselves: a
// pixel holding a layer is settled only where the segment's ids strictly
// ascend (keys_ascend; a -1 hole after a live id reads as not ascending,
// which only costs the stop), or where its `last` is the table's largest
// id. The segments' layers merge by a min (merge_min); then emit(row, col,
// best) for each of the block's 1/PEEL_SPLIT of the tile's pixels (rows
// the frame's, over `band` as in vis_tile). A tile
// of one segment is block 0's alone: no merge, no cluster barrier, emit
// for all its pixels. Every thread of the block must call it.
template <class T, int ROW_STRIDE, typename Emit>
__device__ __forceinline__ void peel_tile(const float* __restrict__ table, int n_tris,
                                          const int* __restrict__ bins,
                                          const int* __restrict__ counts, int bin_width,
                                          int tiles_x, const float* __restrict__ z_base,
                                          const int* __restrict__ last, const Band& band,
                                          Emit&& emit) {
  constexpr int BATCH = T::THREADS;   // entries staged a pass, one a thread
  static_assert(T::PIX <= BATCH * COEF_STRIDE, "the merge buffer fits the batch");
  // the batch's plane coefficients, then the segment's layer ids for the merge
  __shared__ float scoef[BATCH * COEF_STRIDE];
  __shared__ int sid[BATCH];
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / PEEL_SPLIT;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x + band.y0 / T::H;   // the frame's tile row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rx0 = (warp % T::REGIONS_X) * REGION_W;   // region in the tile
  const int ry0 = (warp / T::REGIONS_X) * REGION_H;
  const Region region(tx * T::W + rx0, ty * T::H + ry0);
  // bins and counts come from the caller: never walk past the bin row
  const int n = max(0, min(counts[tile], bin_width));
  int e0, e1;
  const int segs = tile_segment(n, PEEL_SPLIT, DEFERRED_SEG_MIN, rank, &e0, &e1);
  if (segs == 1 && rank > 0) return;

  PeelPixels<true> s;
  if (rank < segs) {   // uniform across the block
    s.load(z_base, last, tx * T::W + rx0 + lane, ty * T::H + ry0, band, n_tris - 1);
    peel_walk<ROW_STRIDE, BATCH>(table, n_tris, bins + static_cast<size_t>(tile) * bin_width,
                                 e0, e1, region, scoef, sid, s);
  }
  if (segs == 1) {
#pragma unroll
    for (int i = 0; i < REGION_H; ++i)
      emit(ty * T::H + ry0 + i, tx * T::W + rx0 + lane, s.best[i]);
    return;
  }
  __syncthreads();   // the batch buffer is free for the merge

  const int best =
      merge_min<T>(cluster, reinterpret_cast<int*>(scoef), s, rx0, ry0, rank, segs);
  const int p = rank * T::THREADS + threadIdx.x;
  emit(ty * T::H + p / T::W, tx * T::W + p % T::W, best);
}

// peel_tile_passes' dynamic shared memory, in floats: a batch's plane
// coefficients and ids, then the tile's layer ids for the merge (kept
// from pass to pass).
template <class T>
struct PeelSmem {
  static constexpr int BATCH = T::THREADS * COEF_STRIDE;
  static constexpr int BYTES = (BATCH + T::THREADS + T::PIX) * 4;
};

// peel_tile for a tile of several passes: each pass's warps walk their
// regions over the block's segment, with peel_tile's reject and stops,
// and park their layer ids (park_best); after the last pass the merge
// (merge_min_passes) and emit run for the block's 1/PEEL_SPLIT of the
// tile's pixels, T::PASSES a thread.
template <class T, int ROW_STRIDE, typename Emit>
__device__ __forceinline__ void peel_tile_passes(const float* __restrict__ table, int n_tris,
                                                 const int* __restrict__ bins,
                                                 const int* __restrict__ counts, int bin_width,
                                                 int tiles_x, const float* __restrict__ z_base,
                                                 const int* __restrict__ last, const Band& band,
                                                 Emit&& emit) {
  constexpr int BATCH = T::THREADS;   // entries staged a batch, one a thread
  using S = PeelSmem<T>;
  static_assert(T::PASSES > 1, "a tile of one pass takes peel_tile");
  float* scoef = dynamic_smem();
  int* sid = reinterpret_cast<int*>(scoef + S::BATCH);
  int* merge = sid + BATCH;
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int tile = blockIdx.x / PEEL_SPLIT;
  const int tx = tile % tiles_x;
  const int ty = tile / tiles_x + band.y0 / T::H;   // the frame's tile row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  // bins and counts come from the caller: never walk past the bin row
  const int n = max(0, min(counts[tile], bin_width));
  int e0, e1;
  const int segs = tile_segment(n, PEEL_SPLIT, DEFERRED_SEG_MIN, rank, &e0, &e1);
  if (segs == 1 && rank > 0) return;
  const int* tbins = bins + static_cast<size_t>(tile) * bin_width;

  for (int pass = 0; pass < T::PASSES; ++pass) {
    const int q = pass * T::WARPS + warp;
    const int rx0 = region_x0<T>(q);   // region in the tile
    const int ry0 = region_y0<T>(q);
    const Region region(tx * T::W + rx0, ty * T::H + ry0);
    PeelPixels<true> s;
    if (rank < segs) {   // uniform across the block
      s.load(z_base, last, tx * T::W + rx0 + lane, ty * T::H + ry0, band, n_tris - 1);
      peel_walk<ROW_STRIDE, BATCH>(table, n_tris, tbins, e0, e1, region, scoef, sid, s);
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

// Launch a kernel of vis_tile's shape: n_tiles clusters of VIS_SPLIT
// blocks of T::THREADS, with `bytes` of dynamic shared memory (0 for
// vis_tile; VisSmem<T>::BYTES for vis_tile_passes). The cluster is a launch attribute, so a split
// above the portable 8 needs only its constant: the kernel is then allowed
// a non-portable cluster, and the launch is refused (cudaErrorInvalidConfiguration)
// where no such cluster fits on the card. Returns the CUDA error.
template <class T, typename Kernel, typename... Args>
int launch_vis(Kernel kernel, int n_tiles, int bytes, void* stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_tiles * VIS_SPLIT);
  cfg.blockDim = dim3(T::THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = VIS_SPLIT;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (VIS_SPLIT > PORTABLE_CLUSTER) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tr
