// Kernel 2.12: the fused path's shading, mesh.frag (shaders/mesh.frag:12-19)
// with its sampler, over the fused raster's or a peel's planes, and the
// layer's composite as its epilogue.
//
// It replaces no Pallas kernel: the JAX package shades in plain jnp
// (tpu_renderer/kernels/shade.py: shade_fused -> uv_gradients,
// sample_texture, light_and_texture), which XLA fuses into one loop. The
// port's plain version (kernels/shade.py: shade_fused_plain) is that jnp
// operation for operation, a chain of full-frame torch ops (each fused
// multiply-add emulated in float64, ~8 launches), which took ~6.4 ms a call
// at 1920x1088 on the H100; this kernel is its one loop.
//
// What bounds it on the H100: bytes. A pixel reads 20 f32 planes (attrs 6:
// light_num, rgb, uv; meta 13: the texture binding and the uv-gradient
// planes; inv 1) and writes 3 (the rgb form) or reads the framebuffer's 4
// and the hit plane and writes 4 (the epilogue form), against some 60-120
// float operations. The texture taps read the quad atlas (16 B a texel: the
// 2x2 bilinear footprint, prebaked), a few MB that stay in L2. One thread a
// pixel, neighbouring threads on neighbouring pixels of a row, so every
// plane's load is coalesced; no shared memory, no intermediate plane reaches
// device memory. In the epilogue form a pixel the layer did not hit reads
// only its hit byte and its 4 framebuffer words: its shading was never used.
//
// Rounding is the plain version's, operation for operation: the library
// builds with -fmad=false, each fma of the plain version (kernels/common.fma,
// correctly rounded) is an __fmaf_rn here and every other operation an
// explicit round-to-nearest intrinsic; sqrt is the IEEE one, the LOD's log
// is logf (torch's log on the card calls it too); torch.maximum / minimum /
// clamp keep a NaN as torch does, >> on int32 saturates its shift as torch's
// does, a float's conversion to int32 is the same cvt.rzi the torch op
// compiles to, and the fp16 write is __float2half_rn. So the kernel equals
// the plain version on the card bit for bit.

#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 256;
// f32 constants of the plain version: float32(1 / 255), float32(1 / ln 2),
// float32(0.1) (light's floor, mesh.frag:13), float32(1e-12) (rho's floor)
constexpr float INV255 = 0x1.010102p-8f;
constexpr float INV_LN2 = 0x1.715476p+0f;
constexpr float LIGHT_MIN = 0x1.99999ap-4f;
constexpr float RHO_MIN = 0x1.197998p-40f;
// resources.FILTER_*
constexpr int MAG_LINEAR = 1, MIN_LINEAR = 2, MIP_LINEAR = 4;
// the epilogue: none (the rgb planes), the opaque pass's replace, the
// additive blend of a peeled layer
enum Blend { BLEND_NONE = 0, BLEND_REPLACE = 1, BLEND_ADD = 2 };

// torch.maximum / torch.minimum on the card: a NaN operand wins
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp(v, min=lo): a NaN stays
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}
// torch's >> on int32: a shift past 30 (or below 0) keeps the sign alone
__device__ __forceinline__ int shr(int a, int b) {
  return (b < 0 || b >= 31) ? a >> 31 : a >> b;
}
// torch.remainder on int32 (b >= 1 here): the floor mod
__device__ __forceinline__ int floor_mod(int a, int b) {
  int r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}
// one RGBA8 channel of a texel word -> f32 in [0, 1] (shade._chan)
__device__ __forceinline__ float chan(int texel, int shift) {
  return __fmul_rn(static_cast<float>((texel >> shift) & 0xFF), INV255);
}

// The sampler's per-pixel texture binding (meta planes 0-5) and atlas.
struct Binding {
  float base_x, base_y, w0, h0, n_levels;
  int flags;
};

// shade._sample_level: one mip tap at `level`, its wrapped quad's gather
// (index 0 where !active, as the plain version's torch.where) and planar
// filtering -> rgb.
template <bool POT>
__device__ __forceinline__ void sample_level(const int4* __restrict__ quads, int n_quads,
                                             int atlas_w, const Binding& t, float level,
                                             float u, float v, bool linear, bool active,
                                             float rgb[3]) {
  const int li = static_cast<int>(level);
  const int w0 = static_cast<int>(t.w0), h0 = static_cast<int>(t.h0);
  // _level_coords
  const int wl = max(shr(w0, li), 1), hl = max(shr(h0, li), 1);
  const float su = __fmaf_rn(u, static_cast<float>(wl), -0.5f);
  const float sv = __fmaf_rn(v, static_cast<float>(hl), -0.5f);
  const int x0 = static_cast<int>(floorf(su)), y0 = static_cast<int>(floorf(sv));
  const float fu = __fsub_rn(su, static_cast<float>(x0));
  const float fv = __fsub_rn(sv, static_cast<float>(y0));
  const int x0w = POT ? (x0 & (wl - 1)) : floor_mod(x0, wl);
  const int y0w = POT ? (y0 & (hl - 1)) : floor_mod(y0, hl);
  // level L of a texture sits at x = base_x + W2 - (W2 >> L), W2 = 2 max(w0, h0)
  const int w2 = static_cast<int>(static_cast<unsigned>(max(w0, h0)) << 1);
  const unsigned ex = static_cast<unsigned>(static_cast<int>(t.base_x) + w2 - shr(w2, li));
  const unsigned ey = static_cast<unsigned>(static_cast<int>(t.base_y));
  // int32 arithmetic, wrapping as torch's does
  int flat = static_cast<int>((ey + y0w) * static_cast<unsigned>(atlas_w) + (ex + x0w));
  if (!active) flat = 0;
  // torch's indexing takes a negative index from the end; past either end it
  // faults, which only a NaN binding reaches: clamp to stay in the atlas
  if (flat < 0) flat += n_quads;
  flat = min(max(flat, 0), n_quads - 1);
  const int4 q = __ldg(quads + flat);   // t00, t10, t01, t11
  const bool nx = fu >= 0.5f, ny = fv >= 0.5f;
  const int nearest = nx ? (ny ? q.w : q.y) : (ny ? q.z : q.x);
  const float w11 = __fmul_rn(fu, fv);
  const float w10 = __fsub_rn(fu, w11);
  const float w01 = __fsub_rn(fv, w11);
  const float w00 = __fsub_rn(__fsub_rn(1.0f, fu), w01);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const int s = 8 * c;
    const float bilin = __fmaf_rn(
        w11, chan(q.w, s),
        __fmaf_rn(w01, chan(q.z, s), __fmaf_rn(w10, chan(q.y, s), __fmul_rn(w00, chan(q.x, s)))));
    rgb[c] = linear ? bilin : chan(nearest, s);
  }
}

// shade.sample_texture: the analytic LOD, nearest / linear filtering, one or
// (TRILINEAR) two mip taps.
template <bool TRILINEAR, bool POT>
__device__ __forceinline__ void sample_texture(const int4* __restrict__ quads, int n_quads,
                                               int atlas_w, const Binding& t, float u, float v,
                                               float dudx, float dudy, float dvdx, float dvdy,
                                               float tex[3]) {
  const float ax = __fmul_rn(dudx, t.w0), bx = __fmul_rn(dvdx, t.h0);
  const float ay = __fmul_rn(dudy, t.w0), by = __fmul_rn(dvdy, t.h0);
  const float rho_x = __fsqrt_rn(__fmaf_rn(ax, ax, __fmul_rn(bx, bx)));
  const float rho_y = __fsqrt_rn(__fmaf_rn(ay, ay, __fmul_rn(by, by)));
  const float rho = tmax(rho_x, rho_y);
  const float max_level = __fsub_rn(t.n_levels, 1.0f);
  const float lod = tmin(clamp_min(__fmul_rn(logf(clamp_min(rho, RHO_MIN)), INV_LN2), 0.0f),
                         max_level);
  const bool mip_linear = (t.flags & MIP_LINEAR) != 0;
  // Vulkan: NEAREST mip mode picks ceil(lod + 0.5) - 1; LINEAR blends
  // floor / floor + 1 by the fraction
  const float l_near = tmin(clamp_min(__fsub_rn(ceilf(__fadd_rn(lod, 0.5f)), 1.0f), 0.0f),
                            max_level);
  const float l_lo = floorf(lod);
  const float l_hi = tmin(__fadd_rn(l_lo, 1.0f), max_level);
  const float frac = mip_linear ? __fsub_rn(lod, l_lo) : 0.0f;
  const float lev_a = mip_linear ? l_lo : l_near;
  const float lev_b = mip_linear ? l_hi : l_near;
  const bool linear = lod > 0.0f ? (t.flags & MIN_LINEAR) != 0 : (t.flags & MAG_LINEAR) != 0;
  sample_level<POT>(quads, n_quads, atlas_w, t, lev_a, u, v, linear, true, tex);
  if (!TRILINEAR) return;
  float b[3];
  sample_level<POT>(quads, n_quads, atlas_w, t, lev_b, u, v, linear, frac > 0.0f, b);
  const float keep = __fsub_rn(1.0f, frac);
#pragma unroll
  for (int c = 0; c < 3; ++c) tex[c] = __fmaf_rn(tex[c], keep, __fmul_rn(b[c], frac));
}

// shade.shade_fused_plain at pixel p of planes of n pixels: uv_gradients ->
// sample_texture -> light_and_texture.
template <bool TEXTURED, bool TRILINEAR, bool POT>
__device__ __forceinline__ void shade_pixel(const float* __restrict__ attrs,
                                            const float* __restrict__ meta,
                                            const float* __restrict__ inv_plane,
                                            const int4* __restrict__ quads, int n_quads,
                                            int atlas_w, float amb_r, float amb_g, float amb_b,
                                            float sun_power, size_t p, size_t n, float rgb[3]) {
  const float light_num = attrs[p];
  const float color[3] = {attrs[n + p], attrs[2 * n + p], attrs[3 * n + p]};
  const float amb[3] = {amb_r, amb_g, amb_b};
  // mesh.frag:13-18: light = max(dot(N, sun), 0.1); scale = light * power
  const float scale = __fmul_rn(tmax(light_num, LIGHT_MIN), sun_power);
  if (!TEXTURED) {
    // color * ambient + color * scale, the ambient product fused
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[c] = __fmaf_rn(color[c], amb[c], __fmul_rn(color[c], scale));
    return;
  }
  const float u = attrs[4 * n + p], v = attrs[5 * n + p];
  const float inv = inv_plane[p];
  // uv_gradients: (nu - u * den) contracted to fma(-u, den, nu), times inv
  const float nu_a = meta[6 * n + p], nu_b = meta[7 * n + p];
  const float nv_a = meta[8 * n + p], nv_b = meta[9 * n + p];
  const float den_a = meta[10 * n + p], den_b = meta[11 * n + p];
  const float dudx = __fmul_rn(__fmaf_rn(-u, den_a, nu_a), inv);
  const float dudy = __fmul_rn(__fmaf_rn(-u, den_b, nu_b), inv);
  const float dvdx = __fmul_rn(__fmaf_rn(-v, den_a, nv_a), inv);
  const float dvdy = __fmul_rn(__fmaf_rn(-v, den_b, nv_b), inv);
  const Binding t{meta[p], meta[n + p], meta[2 * n + p], meta[3 * n + p], meta[4 * n + p],
                  static_cast<int>(meta[5 * n + p])};
  float tex[3];
  sample_texture<TRILINEAR, POT>(quads, n_quads, atlas_w, t, u, v, dudx, dudy, dvdx, dvdy, tex);
  // color * scale + color * ambient, the scale product fused
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float col = __fmul_rn(color[c], tex[c]);
    rgb[c] = __fmaf_rn(col, scale, __fmul_rn(col, amb[c]));
  }
}

__device__ __forceinline__ float half_round(float x) {
  return __half2float(__float2half_rn(x));
}

// One thread a pixel. blend BLEND_NONE: out is the (3, n) rgb planes of
// every pixel. Otherwise out is the (4, n) framebuffer: where hit, rgb
// replaces fb (alpha 1) or is added over it as src + dst * dstAlpha (alpha
// 1); elsewhere fb stays; fp16 rounds every word through half. out may be
// fb itself: a thread reads its pixel before it writes it.
template <bool TEXTURED, bool TRILINEAR, bool POT>
__global__ void __launch_bounds__(BLOCK)
shade_fused_kernel(const float* __restrict__ attrs, const float* __restrict__ meta,
                   const float* __restrict__ inv, const int4* __restrict__ quads, int n_quads,
                   int atlas_w, const float* __restrict__ ambient,
                   const float* __restrict__ sun_power, const float* fb,
                   const unsigned char* __restrict__ hit, float* out, int n_pixels, int blend,
                   int fp16) {
  const size_t n = static_cast<size_t>(n_pixels);
  const size_t p = static_cast<size_t>(blockIdx.x) * BLOCK + threadIdx.x;
  if (p >= n) return;
  float rgb[3];
  if (blend == BLEND_NONE) {
    shade_pixel<TEXTURED, TRILINEAR, POT>(attrs, meta, inv, quads, n_quads, atlas_w, ambient[0],
                                          ambient[1], ambient[2], *sun_power, p, n, rgb);
#pragma unroll
    for (int c = 0; c < 3; ++c) out[c * n + p] = rgb[c];
    return;
  }
  float o[4] = {fb[p], fb[n + p], fb[2 * n + p], fb[3 * n + p]};
  if (hit[p]) {
    shade_pixel<TEXTURED, TRILINEAR, POT>(attrs, meta, inv, quads, n_quads, atlas_w, ambient[0],
                                          ambient[1], ambient[2], *sun_power, p, n, rgb);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      o[c] = blend == BLEND_REPLACE ? rgb[c] : __fmaf_rn(o[c], o[3], rgb[c]);
    o[3] = 1.0f;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) out[c * n + p] = fp16 ? half_round(o[c]) : o[c];
}

template <bool TEXTURED, bool TRILINEAR, bool POT>
void launch(const float* attrs, const float* meta, const float* inv, const int4* quads,
            int n_quads, int atlas_w, const float* ambient, const float* sun_power,
            const float* fb, const unsigned char* hit, float* out, int n_pixels, int blend,
            int fp16, cudaStream_t stream) {
  const int blocks = (n_pixels + BLOCK - 1) / BLOCK;
  shade_fused_kernel<TEXTURED, TRILINEAR, POT><<<blocks, BLOCK, 0, stream>>>(
      attrs, meta, inv, quads, n_quads, atlas_w, ambient, sun_power, fb, hit, out, n_pixels,
      blend, fp16);
}

}  // namespace

// attrs (6, n), meta (13, n), inv (n) f32 planes of n = Hp * Wp pixels;
// quads (n_quads, 4) i32, the atlas atlas_w quads wide; ambient (3,) and
// sun_power (1,) f32 on the card; fb (4, n) f32 and hit (n) bool, read when
// blend is not 0; out (3, n) or (4, n). The statics pick the instance:
// untextured takes neither trilinear nor pot. Returns the launch's CUDA error.
extern "C" int shade_fused_launch(const float* attrs, const float* meta, const float* inv,
                                  const int* quads, int n_quads, int atlas_w,
                                  const float* ambient, const float* sun_power, const float* fb,
                                  const unsigned char* hit, float* out, int n_pixels,
                                  int textured, int trilinear, int pot, int blend, int fp16,
                                  cudaStream_t stream) {
  if (n_pixels <= 0) return static_cast<int>(cudaSuccess);
  const int4* q = reinterpret_cast<const int4*>(quads);
#define TR_SHADE_ARGS \
  attrs, meta, inv, q, n_quads, atlas_w, ambient, sun_power, fb, hit, out, n_pixels, blend, fp16, \
      stream
  if (!textured)
    launch<false, false, false>(TR_SHADE_ARGS);
  else if (trilinear && pot)
    launch<true, true, true>(TR_SHADE_ARGS);
  else if (trilinear)
    launch<true, true, false>(TR_SHADE_ARGS);
  else if (pot)
    launch<true, false, true>(TR_SHADE_ARGS);
  else
    launch<true, false, false>(TR_SHADE_ARGS);
#undef TR_SHADE_ARGS
  return static_cast<int>(cudaGetLastError());
}
