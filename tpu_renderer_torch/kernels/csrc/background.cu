// Kernels 2.9, 2.10 and 2.11: the background compute passes, each writing
// the planar (4, Hp, Wp) f32 framebuffer, padding included.
//
// 2.9 replaces the Pallas kernel background._gradient_kernel of the JAX
// package (tpu_renderer/kernels/background.py, from gradient): per row
// mix(data1, data2, y / height) (gradient_color.comp:14-27).
// 2.10 replaces background._sky_kernel (from sky): a hash-noise star field,
// bilinear over the 4 lattice stars around the pixel, plus rgb * y / height;
// alpha 1 (sky.comp:17-91).
// 2.11 replaces background._grid_kernel (from grid_gradient): the x / width,
// y / height ramp, black on the 16-pixel grid lines; b 0, alpha 1
// (gradient.comp:11-28).
//
// What bounds them on the H100: bytes. Each writes 16 B a pixel and reads
// next to nothing (two 4-float parameter vectors; for the sky its lattice
// cosines, Wp + 1 and Hp + 1 floats, which stay in L1/L2), against at most
// ~60 float operations a pixel for the sky and a handful for the others.
// A lane computes 4 neighbouring pixels of a row in registers and writes
// each of the 4 planes with one 16-byte store, a warp covering one
// 128-pixel row segment, 512 contiguous bytes a plane; no shared memory,
// no intermediate plane ever reaches device memory (the plain PyTorch
// version writes some forty). The padded width is whole raster tiles, 64
// or 128 pixels wide: a row's last segment may be half of one (1700 pads
// to 1728 at 64-pixel tiles), whose lanes past the width store nothing.
//
// 2.9 and 2.10 give each warp one 128-pixel row segment (the warps of a
// block take neighbouring segments of a row, then the next row's) and store
// with the streaming hint. 2.9 computes its four mix values once a lane;
// 2.10 computes each lattice star once a lane: pixel (x, y) blends the
// stars at lattice points (x | x+1, y | y+1), so a lane's 4 pixels share
// the 10 stars of columns x..x+4 on rows y and y+1 instead of taking 16.
// 2.11 keeps one 4-pixel step a lane over a block a (row band, segment).
//
// Rounding is spelled out as in the raster kernels: the library builds with
// -fmad=false, every fused multiply-add the JAX reference has on the CPU is
// an __fmaf_rn here, every other operation an explicit round-to-nearest
// intrinsic, and a division by a constant extent is a multiply by its f32
// reciprocal, as XLA evaluates it. The sky's lattice cosines are not taken
// here: CUDA's cosf is not the C library's, an ulp of which 415.9x
// amplifies into another star, so the host evaluates them and the kernel
// reads them; everything per pixel runs here.

#include <cuda_runtime.h>

namespace {

constexpr int VEC = 4;         // pixels a lane, one float4 store a plane
constexpr int BLOCK_X = 32;    // lanes: a warp a row segment
constexpr int SEGMENT = BLOCK_X * VEC;  // 128 pixels
constexpr int BLOCK_Y = 8;              // 2.11: rows a block
constexpr int SEGMENT_WARPS = 8;        // 2.9, 2.10: warps (row segments) a block
constexpr int GRID_CELL = 16;           // gradient.comp's workgroup edge

__device__ __forceinline__ float recip(int n) {
  return __fdiv_rn(1.0f, static_cast<float>(n));
}

__device__ __forceinline__ float fract(float v) { return __fsub_rn(v, floorf(v)); }

__device__ __forceinline__ void store4(float* plane, size_t p, float a, float b, float c,
                                       float d) {
  *reinterpret_cast<float4*>(plane + p) = make_float4(a, b, c, d);
}

// 2.9, 2.10: the same store with the streaming hint (evict first): nothing
// reads the buffer back in the kernel, and on the H100 it measured ~0.3 us
// faster than store4 (tools/time_background.py)
__device__ __forceinline__ void stream4(float* plane, size_t p, float a, float b, float c,
                                        float d) {
  __stcs(reinterpret_cast<float4*>(plane + p), make_float4(a, b, c, d));
}

// 2.11: the first pixel of this thread and its offset in a plane; false
// for a thread past the extent.
__device__ __forceinline__ bool thread_pixel(int wp, int hp, int* x, int* y, size_t* p) {
  *x = (blockIdx.x * BLOCK_X + threadIdx.x) * VEC;
  *y = blockIdx.y * BLOCK_Y + threadIdx.y;
  *p = static_cast<size_t>(*y) * wp + *x;
  return *x < wp && *y < hp;
}

// 2.9, 2.10: this lane's first pixel. Warp g of the launch takes the row
// segment g % segs of row g / segs, segs = ceil(wp / SEGMENT); false for a
// lane past the width (the half segment of an odd multiple of 64) or a
// warp past the last row.
__device__ __forceinline__ bool segment_pixel(int wp, int hp, int* x, int* y, size_t* p) {
  const int segs = (wp + SEGMENT - 1) / SEGMENT;
  const int g = blockIdx.x * SEGMENT_WARPS + threadIdx.x / BLOCK_X;
  *y = g / segs;
  *x = (g - *y * segs) * SEGMENT + (threadIdx.x % BLOCK_X) * VEC;
  *p = static_cast<size_t>(*y) * wp + *x;
  return *x < wp && *y < hp;
}

__global__ void __launch_bounds__(BLOCK_X * SEGMENT_WARPS)
background_gradient_kernel(const float* __restrict__ data1,
                           const float* __restrict__ data2, int height, int wp, int hp,
                           float* __restrict__ out) {
  int x, y;
  size_t p;
  if (!segment_pixel(wp, hp, &x, &y, &p)) return;
  const size_t plane = static_cast<size_t>(hp) * wp;
  const float blend = __fmul_rn(static_cast<float>(y), recip(height));
  const float rest = __fsub_rn(1.0f, blend);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    // mix(d1, d2, a) = d1 * (1 - a) + d2 * a, contracted as fma(d2, a, d1 * (1 - a))
    const float mix = __fmaf_rn(data2[c], blend, __fmul_rn(data1[c], rest));
    const float v = __fadd_rn(mix, 0.0f);   // the broadcast add: -0 becomes +0
    stream4(out + c * plane, p, v, v, v, v);
  }
}

// sky.comp:18-33: the lattice noise from its two cosines, then the
// threshold and the pow6 shaping (x2 * (x2 * x2), as the reference
// multiplies it).
__device__ __forceinline__ float star(float cx, float cy, float threshold, float span) {
  const float v = fract(__fmul_rn(415.92653f, __fadd_rn(cx, cy)));
  const float s = __fdiv_rn(__fsub_rn(v, threshold), span);
  const float s2 = __fmul_rn(s, s);
  const float shaped = __fmul_rn(s2, __fmul_rn(s2, s2));
  return v >= threshold ? shaped : 0.0f;
}

// lat_x: the lattice's column cosines, Wp + 1 (column i's is cos(floor(i +
// 0.2) * 37)); lat_y: its row cosines, Hp + 1 (cos(floor(j - 0.06) * 57)).
// Pixel (x, y) blends the stars of columns x, x+1 and rows y, y+1.
__global__ void __launch_bounds__(BLOCK_X * SEGMENT_WARPS)
background_sky_kernel(const float* __restrict__ data1, const float* __restrict__ lat_x,
                      const float* __restrict__ lat_y, int height, int wp, int hp,
                      float* __restrict__ out) {
  int x, y;
  size_t p;
  if (!segment_pixel(wp, hp, &x, &y, &p)) return;
  const size_t plane = static_cast<size_t>(hp) * wp;
  const float threshold = data1[3];
  const float span = __fsub_rn(1.0f, threshold);
  // the lane's 5 lattice cosines, columns x..x+4, and the stars of lattice
  // rows y (above) and y+1 (below) on them
  const float4 b = *reinterpret_cast<const float4*>(lat_x + x);
  const float cx[VEC + 1] = {b.x, b.y, b.z, b.w, lat_x[x + VEC]};
  const float cy0 = lat_y[y], cy1 = lat_y[y + 1];
  float above[VEC + 1], below[VEC + 1];
#pragma unroll
  for (int j = 0; j <= VEC; ++j) {
    above[j] = star(cx[j], cy0, threshold, span);
    below[j] = star(cx[j], cy1, threshold, span);
  }
  // sky.comp:67-69: crawl offset (0.2, -0.06) * frame 1
  const float yf = static_cast<float>(y);
  const float fy = fract(__fadd_rn(yf, -0.06f));
  const float ry = __fsub_rn(1.0f, fy);
  float st[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float fx = fract(__fadd_rn(static_cast<float>(x + i), 0.2f));
    const float rx = __fsub_rn(1.0f, fx);
    // bilinear blend of the 4 lattice stars (sky.comp:36-54)
    float s = __fmaf_rn(__fmul_rn(above[i], rx), ry, __fmul_rn(__fmul_rn(below[i], rx), fy));
    s = __fmaf_rn(__fmul_rn(above[i + 1], fx), ry, s);
    st[i] = __fmaf_rn(__fmul_rn(below[i + 1], fx), fy, s);
  }
  // sky.comp:60: rgb * y / height as (rgb * (1 / height)) * y
  const float r = recip(height);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float g = __fmul_rn(__fmul_rn(data1[c], r), yf);
    stream4(out + c * plane, p, __fadd_rn(g, st[0]), __fadd_rn(g, st[1]),
            __fadd_rn(g, st[2]), __fadd_rn(g, st[3]));
  }
  stream4(out + 3 * plane, p, 1.0f, 1.0f, 1.0f, 1.0f);
}

__global__ void __launch_bounds__(BLOCK_X * BLOCK_Y)
background_grid_kernel(int height, int width, int wp, int hp, float* __restrict__ out) {
  int x, y;
  size_t p;
  if (!thread_pixel(wp, hp, &x, &y, &p)) return;
  const size_t plane = static_cast<size_t>(hp) * wp;
  const bool row_on = y % GRID_CELL != 0;
  const float g = row_on ? __fmul_rn(static_cast<float>(y), recip(height)) : 0.0f;
  const float rw = recip(width);
  float r[VEC], gg[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    // gradient.comp:20: black where the 16x16 workgroup-local id is 0
    const bool on = row_on && (x + i) % GRID_CELL != 0;
    r[i] = on ? __fmul_rn(static_cast<float>(x + i), rw) : 0.0f;
    gg[i] = on ? g : 0.0f;
  }
  store4(out, p, r[0], r[1], r[2], r[3]);
  store4(out + plane, p, gg[0], gg[1], gg[2], gg[3]);
  store4(out + 2 * plane, p, 0.0f, 0.0f, 0.0f, 0.0f);
  store4(out + 3 * plane, p, 1.0f, 1.0f, 1.0f, 1.0f);
}

// The kernels take any padded extent of whole 4-pixel steps a row (a
// lane's float4 stores); the wrappers hold it to whole raster tiles.
bool extent_ok(int wp, int hp) { return wp > 0 && hp > 0 && wp % VEC == 0; }

// 2.11's launch grid over a padded extent, or false for an extent it does
// not take.
bool launch_grid(int wp, int hp, dim3* grid) {
  if (!extent_ok(wp, hp)) return false;
  *grid = dim3((wp + SEGMENT - 1) / SEGMENT, (hp + BLOCK_Y - 1) / BLOCK_Y);
  return true;
}

// 2.9 and 2.10's: one warp a row segment, SEGMENT_WARPS a block.
bool segment_grid(int wp, int hp, dim3* grid) {
  if (!extent_ok(wp, hp)) return false;
  const long long warps = static_cast<long long>((wp + SEGMENT - 1) / SEGMENT) * hp;
  *grid = dim3(static_cast<unsigned>((warps + SEGMENT_WARPS - 1) / SEGMENT_WARPS));
  return true;
}

const dim3 BLOCK(BLOCK_X, BLOCK_Y);

}  // namespace

extern "C" int background_gradient_launch(const float* data1, const float* data2,
                                          int height, int wp, int hp, float* out,
                                          void* stream) {
  dim3 grid;
  if (!segment_grid(wp, hp, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  background_gradient_kernel<<<grid, BLOCK_X * SEGMENT_WARPS, 0,
                               static_cast<cudaStream_t>(stream)>>>(data1, data2, height,
                                                                    wp, hp, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int background_sky_launch(const float* data1, const float* lat_x,
                                     const float* lat_y, int height, int wp, int hp,
                                     float* out, void* stream) {
  dim3 grid;
  if (!segment_grid(wp, hp, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  background_sky_kernel<<<grid, BLOCK_X * SEGMENT_WARPS, 0,
                          static_cast<cudaStream_t>(stream)>>>(data1, lat_x, lat_y, height,
                                                               wp, hp, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int background_grid_launch(int height, int width, int wp, int hp, float* out,
                                      void* stream) {
  dim3 grid;
  if (!launch_grid(wp, hp, &grid)) return static_cast<int>(cudaErrorInvalidValue);
  background_grid_kernel<<<grid, BLOCK, 0, static_cast<cudaStream_t>(stream)>>>(
      height, width, wp, hp, out);
  return static_cast<int>(cudaGetLastError());
}
