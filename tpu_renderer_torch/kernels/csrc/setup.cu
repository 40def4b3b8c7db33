// Kernel 2.13: the fused path's triangle setup, mesh.vert and the
// fixed-function primitive assembly, into the 48-column fat rows of
// kernels/shade.py, the screen boxes and the liveness flags.
//
// It replaces no Pallas kernel: the JAX package writes the setup in jnp
// (tpu_renderer/kernels/vertex.py: triangle_setup_rows), which XLA fuses into
// one loop. The port's plain version (kernels/vertex.py:
// triangle_setup_rows_plain) is that jnp operation for operation, a chain of
// ~1,000 torch operations over the triangles (each of its ~89 fused
// multiply-adds emulated in float64, ~10 launches), which took 3.76 ms a frame
// over grid 64's 46,250 triangles on the H100; this kernel is its one loop.
//
// What bounds it on the H100: bytes. A triangle reads 160 B of corners
// (positions, normals and colours 36 B each, uvs 24, the material 4, the
// texture binding 24) and writes its 192 B fat row, its 16 B box and its 1 B
// flag, against some 500 float operations: ~17 MB a frame at grid 64, ~5 us
// at the HBM rate. One thread a triangle, in blocks of 128 (362 blocks over
// the 132 SMs at grid 64). A block stages its span of each corner array in
// shared memory with coalesced 16-byte loads, and its span of rows likewise
// on the way out, so every access to device memory is coalesced; a thread
// stores its box (16 B) and flag itself, in the same pass. A draw's
// model-view-projection and the sun in its mesh space are recomputed a
// triangle, in the plain version's order: its 64 B transform stays in L1 and
// L2, and the result is exact by construction with no second launch.
//
// Rounding is the plain version's, operation for operation: the library
// builds with -fmad=false, each fma of the plain version (kernels/common.fma,
// correctly rounded) is an __fmaf_rn here and every other operation an
// explicit round-to-nearest intrinsic in the plain version's order (the 4x4
// products summed pairwise, a dot's last term added after its fmas); the
// divides are IEEE divides; torch.minimum / maximum / clamp keep a NaN as
// torch's do. So the kernel equals the plain version on the card bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BLOCK = 128;
constexpr int ROW = 48;       // the fat row's columns
constexpr int ROW_PAD = 49;   // a row's stride in shared memory: odd, so no bank conflicts
// float32(1e-6) (the eye-plane margin of the boxes), float32(1e-20) (w's
// stand-in for 0)
constexpr float W_EPS = 1e-6f;
constexpr float W_ZERO = 1e-20f;

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
// vertex._dot3: x0*y0 + x1*y1 + x2*y2 as fma(x2, y2, fma(x0, y0, x1*y1))
__device__ __forceinline__ float dot3(float x0, float y0, float x1, float y1, float x2,
                                      float y2) {
  return __fmaf_rn(x2, y2, __fmaf_rn(x0, y0, __fmul_rn(x1, y1)));
}
// vertex._cross: u x v, each component fma(a, b, -(c*d))
__device__ __forceinline__ void cross(const float u[3], const float v[3], float out[3]) {
  out[0] = __fmaf_rn(u[1], v[2], -__fmul_rn(u[2], v[1]));
  out[1] = __fmaf_rn(u[2], v[0], -__fmul_rn(u[0], v[2]));
  out[2] = __fmaf_rn(u[0], v[1], -__fmul_rn(u[1], v[0]));
}

// Copy src[0, count) to the block's shared dst[0, count): 16 bytes a thread
// where src starts on a 16-byte boundary (dst always does), 4 otherwise.
__device__ __forceinline__ void stage(const float* __restrict__ src, float* dst, int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int quads = count >> 2;
    for (int q = threadIdx.x; q < quads; q += BLOCK)
      reinterpret_cast<float4*>(dst)[q] = __ldg(reinterpret_cast<const float4*>(src) + q);
    done = quads << 2;
  }
  for (int k = done + threadIdx.x; k < count; k += BLOCK) dst[k] = __ldg(src + k);
}

// One thread a triangle. pos, nrm, col (n, 3, 3), uv (n, 3, 2), mat (n),
// meta6 (n, 6): CornerData; tri_draw (n) with -1 on padding rows; tri_valid
// (n); draw_model (n_draws, 4, 4); draw_visible (n_draws); viewproj (4, 4);
// sun (3) or null (the zero vector). Writes rows (n, 48), aabb (n, 4) and
// valid (n).
__global__ void __launch_bounds__(BLOCK)
triangle_setup_kernel(const float* __restrict__ pos, const float* __restrict__ nrm,
                      const float* __restrict__ col, const float* __restrict__ uv,
                      const int* __restrict__ mat, const float* __restrict__ meta6,
                      const int* __restrict__ tri_draw,
                      const unsigned char* __restrict__ tri_valid,
                      const float* __restrict__ draw_model,
                      const unsigned char* __restrict__ draw_visible, int n_draws,
                      const float* __restrict__ viewproj, const float* __restrict__ sun,
                      int n, int width, int height, float* __restrict__ rows,
                      float4* __restrict__ aabb, unsigned char* __restrict__ valid) {
  __shared__ __align__(16) float s_pos[BLOCK * 9];
  __shared__ __align__(16) float s_nrm[BLOCK * 9];
  __shared__ __align__(16) float s_col[BLOCK * 9];
  __shared__ __align__(16) float s_uv[BLOCK * 6];
  __shared__ __align__(16) float s_meta[BLOCK * 6];
  __shared__ float s_rows[BLOCK * ROW_PAD];

  const int t0 = blockIdx.x * BLOCK;
  const int count = min(BLOCK, n - t0);
  const size_t first = static_cast<size_t>(t0);
  stage(pos + first * 9, s_pos, count * 9);
  stage(nrm + first * 9, s_nrm, count * 9);
  stage(col + first * 9, s_col, count * 9);
  stage(uv + first * 6, s_uv, count * 6);
  stage(meta6 + first * 6, s_meta, count * 6);
  __syncthreads();

  const int k = threadIdx.x;
  if (k < count) {
    const int t = t0 + k;
    const int draw = tri_draw[t];
    // padding rows carry draw -1: torch's indexing takes it from the end
    // (the last draw) and good masks the row; an id past either end, which
    // torch's indexing refuses, is held inside the draws
    const int d = min(max(draw < 0 ? draw + n_draws : draw, 0), n_draws - 1);

    // vertex._homogeneous: mvp = mat4_mul(viewproj, model[d]), each entry
    // (a[i,0]*b[0,j] + a[i,1]*b[1,j]) + (a[i,2]*b[2,j] + a[i,3]*b[3,j])
    const float* model = draw_model + static_cast<size_t>(d) * 16;
    float m[16], vp[16];
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      m[q] = __ldg(model + q);
      vp[q] = __ldg(viewproj + q);
    }
    float mvp[16];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mvp[4 * i + j] = __fadd_rn(
            __fadd_rn(__fmul_rn(vp[4 * i], m[j]), __fmul_rn(vp[4 * i + 1], m[4 + j])),
            __fadd_rn(__fmul_rn(vp[4 * i + 2], m[8 + j]), __fmul_rn(vp[4 * i + 3], m[12 + j])));
    // the sun in the draw's mesh space: ls[i] = sum_j model[j, i] * sd[j]
    const float sd0 = sun ? __ldg(sun) : 0.0f, sd1 = sun ? __ldg(sun + 1) : 0.0f,
                sd2 = sun ? __ldg(sun + 2) : 0.0f;
    float ls[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      ls[i] = __fmaf_rn(m[8 + i], sd2, __fmaf_rn(m[4 + i], sd1, __fmul_rn(m[i], sd0)));
    const float vis = draw_visible[d] ? 1.0f : 0.0f;

    // per corner the viewport-mapped homogeneous point p = (Xh, Yh, w) and
    // clip z: clip[c] = _dot3(pos, mvp[c, :3]) + mvp[c, 3]
    const float half_w = __fmul_rn(0.5f, static_cast<float>(width));
    const float half_h = __fmul_rn(0.5f, static_cast<float>(height));
    float p[3][3], zc[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* v = s_pos + 9 * k + 3 * i;
      float clip[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        clip[c] = __fadd_rn(dot3(v[0], mvp[4 * c], v[1], mvp[4 * c + 1], v[2], mvp[4 * c + 2]),
                            mvp[4 * c + 3]);
      p[i][0] = __fmul_rn(__fadd_rn(clip[0], clip[3]), half_w);
      p[i][1] = __fmul_rn(__fadd_rn(clip[1], clip[3]), half_h);
      p[i][2] = clip[3];
      zc[i] = clip[2];
    }

    // vertex._edge_planes
    float e[3][3];
    cross(p[1], p[2], e[0]);
    cross(p[2], p[0], e[1]);
    cross(p[0], p[1], e[2]);
    const float det = dot3(e[0][0], p[0][0], e[0][1], p[0][1], e[0][2], p[0][2]);
    const bool good = tri_valid[t] && draw >= 0 && vis > 0.0f && det != 0.0f && isfinite(det);
    const float s = det < 0.0f ? -1.0f : 1.0f;
    const float inv_det = det == 0.0f ? 0.0f : __fdiv_rn(1.0f, fabsf(det));
    const float dead[3] = {0.0f, 0.0f, -1.0f};
    float es[3][3], cp[3][3];
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        es[q][c] = __fmul_rn(e[q][c], s);
        cp[q][c] = good ? __fmul_rn(es[q][c], inv_det) : dead[c];
      }

    float* row = s_rows + ROW_PAD * k;
#pragma unroll
    for (int q = 0; q < 3; ++q)
#pragma unroll
      for (int c = 0; c < 3; ++c) row[3 * q + c] = cp[q][c];               // 0-8 edges
#pragma unroll
    for (int c = 0; c < 3; ++c)                                             // 9-11 depth
      row[9 + c] = dot3(cp[0][c], zc[0], cp[1][c], zc[1], cp[2][c], zc[2]);
    row[12] = static_cast<float>(mat[t]);                                  // 12 material

    // vertex._screen_aabb: trustworthy only when every w is comfortably
    // positive, else the full frame; dead rows the empty box
    const float W = static_cast<float>(width), H = static_cast<float>(height);
    const bool w_ok = p[0][2] > W_EPS && p[1][2] > W_EPS && p[2][2] > W_EPS;
    float sx[3], sy[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float sw = p[i][2] == 0.0f ? W_ZERO : p[i][2];
      sx[i] = __fdiv_rn(p[i][0], sw);
      sy[i] = __fdiv_rn(p[i][1], sw);
    }
    const float lo_x = w_ok ? tmin(tmin(sx[0], sx[1]), sx[2]) : 0.0f;
    const float lo_y = w_ok ? tmin(tmin(sy[0], sy[1]), sy[2]) : 0.0f;
    const float hi_x = w_ok ? tmax(tmax(sx[0], sx[1]), sx[2]) : W;
    const float hi_y = w_ok ? tmax(tmax(sy[0], sy[1]), sy[2]) : H;
    const float4 box =
        good ? make_float4(tmin(clamp_min(lo_x, 0.0f), W), tmin(clamp_min(lo_y, 0.0f), H),
                           tmin(clamp_min(hi_x, 0.0f), W), tmin(clamp_min(hi_y, 0.0f), H))
             : make_float4(-1.0f, -1.0f, -2.0f, -2.0f);

    // per-corner attributes [light_num, r, g, b, u, v], light_num the
    // corner normal's dot with the mesh-space sun; numerator planes
    // pa / pb / pc = sum_e cp[e][0 / 1 / 2] * attr[e]
    float attr[3][6];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float* nv = s_nrm + 9 * k + 3 * i;
      attr[i][0] = dot3(nv[0], ls[0], nv[1], ls[1], nv[2], ls[2]);
#pragma unroll
      for (int c = 0; c < 3; ++c) attr[i][1 + c] = s_col[9 * k + 3 * i + c];
      attr[i][4] = s_uv[6 * k + 2 * i];
      attr[i][5] = s_uv[6 * k + 2 * i + 1];
    }
    float plane[3][6];   // [pa, pb, pc][attribute]
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int a = 0; a < 6; ++a) {
        plane[c][a] = dot3(cp[0][c], attr[0][a], cp[1][c], attr[1][a], cp[2][c], attr[2][a]);
        row[13 + 6 * c + a] = plane[c][a];                                 // 13-30 attrs
      }
#pragma unroll
    for (int q = 0; q < 6; ++q) row[31 + q] = s_meta[6 * k + q];           // 31-36 tex meta
    // the plane sums, fma(es2, inv_det, fma(es0, inv_det, es1 * inv_det))
    float sums[3];
#pragma unroll
    for (int c = 0; c < 3; ++c)
      sums[c] = good ? __fmaf_rn(es[2][c], inv_det,
                                 __fmaf_rn(es[0][c], inv_det, __fmul_rn(es[1][c], inv_det)))
                     : 3.0f * dead[c];
    row[37] = plane[0][4];                                                 // 37-42 uv grads
    row[38] = plane[1][4];
    row[39] = plane[0][5];
    row[40] = plane[1][5];
    row[41] = sums[0];
    row[42] = sums[1];
    row[43] = sums[2];                                                     // 43 den const
    row[44] = box.x;                                                       // 44-47 aabb
    row[45] = box.y;
    row[46] = box.z;
    row[47] = box.w;
    aabb[t] = box;
    valid[t] = good;
  }
  __syncthreads();

  // the block's rows, one contiguous span, 16 bytes a thread
  float4* out = reinterpret_cast<float4*>(rows + first * ROW);
  for (int q = threadIdx.x; q < count * (ROW / 4); q += BLOCK) {
    const float* src = s_rows + ROW_PAD * (q / (ROW / 4)) + 4 * (q % (ROW / 4));
    out[q] = make_float4(src[0], src[1], src[2], src[3]);
  }
}

}  // namespace

// CornerData's pos, nrm, col (n, 3, 3), uv (n, 3, 2) f32, mat (n) i32, meta6
// (n, 6) f32; tri_draw (n) i32, tri_valid (n) bool; draw_model (n_draws, 4, 4)
// f32, draw_visible (n_draws) bool; viewproj (4, 4) f32; sun (3) f32 or null;
// rows (n, 48) f32 and aabb (n, 4) f32 on 16-byte boundaries, valid (n) bool.
// Returns the launch's CUDA error.
extern "C" int triangle_setup_launch(const float* pos, const float* nrm, const float* col,
                                     const float* uv, const int* mat, const float* meta6,
                                     const int* tri_draw, const unsigned char* tri_valid,
                                     const float* draw_model, const unsigned char* draw_visible,
                                     int n_draws, const float* viewproj, const float* sun, int n,
                                     int width, int height, float* rows, float* aabb,
                                     unsigned char* valid, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + BLOCK - 1) / BLOCK;
  triangle_setup_kernel<<<blocks, BLOCK, 0, stream>>>(
      pos, nrm, col, uv, mat, meta6, tri_draw, tri_valid, draw_model, draw_visible, n_draws,
      viewproj, sun, n, width, height, rows, reinterpret_cast<float4*>(aabb), valid);
  return static_cast<int>(cudaGetLastError());
}
