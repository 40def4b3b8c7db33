"""The frame function — everything the reference does between fence-wait and
present (vk_engine.cpp:1218-1339), as plain PyTorch around two CUDA kernels:

    background compute pass     (draw_background, vk_engine.cpp:1341-1355)
    -> per-draw frustum cull    (is_visible, vk_engine.cpp:56-86)
    -> vertex transform + setup (mesh.vert + primitive assembly)
    -> spatial sort + tile bins
    -> opaque fused raster      (kernel A, raster.rasterize_fused)
    -> deferred shading         (mesh.frag)
    -> transparent accumulation (kernel B, raster.rasterize_accum: the
       additive blend pass, vk_engine.cpp:1673-1676, for untextured
       transparent materials)
    -> unorm8 convert           (swapchain blit, vk_images.cpp:33-64)

The framebuffer is R16G16B16A16_SFLOAT in the reference (vk_engine.cpp:749):
every composite rounds through fp16, exactly where the JAX package's q()
runs. Everything runs on the device the scene buffers live on.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import List, NamedTuple

import numpy as np
import torch

from tpu_renderer_torch.kernels import raster, shade, vertex
from tpu_renderer_torch.kernels.common import fma, pad_extent
from tpu_renderer_torch.present import to_packed_u32
from tpu_renderer_torch.resources import TextureAtlas


class SceneBuffers(NamedTuple):
    """Device-resident scene: the analog of GPUMeshBuffers + material
    descriptor sets + texture images (vk_types.h:106-110, vk_engine.h:45-75).
    Triangle arrays are pre-padded to raster.CHUNK multiples."""

    positions: torch.Tensor          # (V, 3) f32
    normals: torch.Tensor            # (V, 3) f32
    colors: torch.Tensor             # (V, 4) f32
    uvs: torch.Tensor                # (V, 2) f32
    opaque_tri_vidx: torch.Tensor    # (To, 3) i32
    opaque_tri_draw: torch.Tensor    # (To,) i32
    opaque_tri_valid: torch.Tensor   # (To,) bool
    transp_tri_vidx: torch.Tensor    # (Tt, 3) i32
    transp_tri_draw: torch.Tensor    # (Tt,) i32
    transp_tri_valid: torch.Tensor   # (Tt,) bool
    draw_model: torch.Tensor         # (D, 4, 4) f32 node world transforms
    draw_mat: torch.Tensor           # (D,) i32
    draw_opaque_mask: torch.Tensor   # (D,) bool — draw is in the opaque pass
    draw_bounds_origin: torch.Tensor   # (D, 3) f32
    draw_bounds_extents: torch.Tensor  # (D, 3) f32
    mat_color_factors: torch.Tensor  # (M, 4) f32
    mat_meta: torch.Tensor           # (M, 8) f32 — atlas base_x/base_y/w0/h0,
    #                                  n_levels, filter_flags
    atlas: TextureAtlas
    opaque_corners: vertex.CornerData
    transp_corners: vertex.CornerData


class FrameParams(NamedTuple):
    """Per-frame uniforms: GPUSceneData (vk_types.h:118-125) + the background
    push constants (vk_types.h:77-82)."""

    view: torch.Tensor       # (4, 4) f32
    proj: torch.Tensor       # (4, 4) f32
    bg_effect: torch.Tensor  # () i32 — 0 gradient, 1 sky (vk_engine.h:137)
    bg_data1: torch.Tensor   # (4,) f32
    bg_data2: torch.Tensor   # (4,) f32
    ambient: torch.Tensor    # (4,) f32
    sun_dir: torch.Tensor    # (4,) f32 (.xyz as mesh.frag:13)
    sun_color: torch.Tensor  # (4,) f32 (.w = sun power, mesh.frag:18)


def _f32(v, device):
    return torch.tensor(v, dtype=torch.float32, device=device)


def _row_blend(hp: int, height: int, device):
    """y / height per row, as XLA evaluates a division by a constant on the
    CPU: a multiply by the f32 reciprocal."""
    recip = _f32(1.0, device) / _f32(height, device)
    return torch.arange(hp, dtype=torch.float32, device=device) * recip


def _bg_grad(d1, d2, hp: int, wp: int, height: int):
    """gradient_color.comp:14-27 — mix(data1, data2, y / height), with the
    multiply-add contracted as XLA contracts the JAX reference."""
    yy = _row_blend(hp, height, d1.device)[None, :, None]
    mix = fma(d2[:, None, None], yy, d1[:, None, None] * (1.0 - yy))
    return mix + torch.zeros((4, hp, wp), dtype=torch.float32, device=d1.device)


def _fract(x):
    return x - torch.floor(x)


def _pow6(x):
    """x ** 6 as jnp's integer_pow multiplies it: x2 * (x2 * x2)."""
    x2 = x * x
    return x2 * (x2 * x2)


@functools.lru_cache(maxsize=1)
def _libm_cosf():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    lib.cosf.argtypes = [ctypes.c_float]
    lib.cosf.restype = ctypes.c_float
    return lib.cosf


def _lattice_cos(n: int, offset: float, freq: float, device):
    """cos(floor(i + offset) * freq) and cos((floor(i + offset) + 1) * freq)
    for i < n, as f32 planes of length n. The star lattice only ever takes
    the cosine of these values, so it is evaluated on the host, once per
    extent, with the C library's cosf: the function XLA calls for the JAX
    reference on the CPU (measured bit-identical), where f32 cos
    implementations otherwise differ by an ulp that 415.9x amplifies."""
    cosf = _libm_cosf()
    i0 = np.floor(np.arange(n, dtype=np.float32) + np.float32(offset))
    out = []
    for base in (i0, i0 + np.float32(1.0)):
        arg = base * np.float32(freq)
        out.append(torch.tensor([cosf(float(a)) for a in arg],
                                dtype=torch.float32, device=device))
    return out


def _sky(d1, hp: int, wp: int, height: int):
    """sky.comp:17-91 — star-field noise + vertical sky gradient, with the
    operations contracted and reassociated as XLA does for the JAX
    reference on the CPU (measured bit-identical)."""
    dev = d1.device
    r, g, b, threshold = d1[0], d1[1], d1[2], d1[3]
    yy = torch.arange(hp, dtype=torch.float32, device=dev)[:, None].expand(hp, wp)
    xx = torch.arange(wp, dtype=torch.float32, device=dev)[None, :].expand(hp, wp)
    # sky.comp:67-69 — crawl offset (0.2, -0.06) * frame 1
    fx = _fract(xx + _f32(0.2, dev))
    fy = _fract(yy + _f32(-0.06, dev))
    cx0, cx1 = (c[None, :] for c in _lattice_cos(wp, 0.2, 37.0, dev))
    cy0, cy1 = (c[:, None] for c in _lattice_cos(hp, -0.06, 57.0, dev))

    def star(cx, cy):   # sky.comp:18-33: noise, then threshold + pow6
        v = _fract(_f32(415.92653, dev) * (cx + cy))
        shaped = _pow6((v - threshold) / (1.0 - threshold))
        return torch.where(v >= threshold, shaped, _f32(0.0, dev))

    # bilinear blend of the 4 lattice stars (sky.comp:36-54)
    v1, v2 = star(cx0, cy0), star(cx0, cy1)
    v3, v4 = star(cx1, cy0), star(cx1, cy1)
    st = fma(v1 * (1.0 - fx), 1.0 - fy, v2 * (1.0 - fx) * fy)
    st = fma(v3 * fx, 1.0 - fy, st)
    st = fma(v4 * fx, fy, st)
    # sky.comp:60 — rgb * y / height, which XLA reassociates to
    # (rgb * (1 / height)) * y
    recip = _f32(1.0, dev) / _f32(height, dev)
    y1 = torch.arange(hp, dtype=torch.float32, device=dev)[:, None]
    return torch.stack([(r * recip) * y1 + st, (g * recip) * y1 + st,
                        (b * recip) * y1 + st,
                        torch.ones((hp, wp), dtype=torch.float32, device=dev)])


def _background(params: FrameParams, hp: int, wp: int, height: int):
    """Background compute pass (the color attachment then LOADs, not clears:
    vk_initializers.cpp:125)."""
    if int(params.bg_effect.clamp(0, 1)) == 0:
        return _bg_grad(params.bg_data1, params.bg_data2, hp, wp, height)
    return _sky(params.bg_data1, hp, wp, height)


@torch.no_grad()
def background_fb(params: FrameParams, *, width: int, height: int,
                  tile_h: int = 32, tile_w: int = 128):
    """The background pass alone, at the padded draw extent. A pure function
    of the background params, so the Engine caches it across frames."""
    wp, hp = pad_extent(width, height, tile_h, tile_w)
    return _background(params, hp, wp, height)


def _binned(aabb, valid, rows, tiles):
    """Spatial sort -> chunk/group boxes -> dense tile bins."""
    aabb_s, valid_s, rows_s = raster.spatial_sort(aabb, valid, rows)
    caabb, cvalid = raster.chunk_aabbs(aabb_s, valid_s)
    gaabb, gvalid = raster.group_aabbs(aabb_s, valid_s)
    bins, counts = raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **tiles)
    return rows_s.contiguous(), bins, counts


@torch.no_grad()
def render_frame(buffers: SceneBuffers, params: FrameParams, *,
                 width: int, height: int, tile_h: int = 32, tile_w: int = 128,
                 fp16: bool = True, transp_textured: bool = True,
                 fused: bool = True, trilinear: bool = True, pot: bool = False,
                 bg_fb=None):
    """Render one frame. Returns ((H, W) int32 packed-RGBA image — see
    present.unpack_u8 — and an aux dict of device scalars).

    transp_textured: static, does any transparent material bind a texture?
    Only the untextured transparent pass (one accumulation) is ported; a
    scene with transparent triangles and transp_textured=True raises.
    bg_fb: optional precomputed (4, Hp, Wp) background (background_fb)."""
    if not fused:
        raise NotImplementedError(
            "fused=False (the deferred raster path) is not ported yet: "
            "ROADMAP.md Queue 1 item 10")
    wp, hp = pad_extent(width, height, tile_h, tile_w)
    tiles = dict(tiles_x=wp // tile_w, tiles_y=hp // tile_h,
                 tile_w=tile_w, tile_h=tile_h)
    dev = buffers.draw_model.device

    def q(x):
        # the draw image is R16G16B16A16_SFLOAT: writes round to fp16
        return x.half().float() if fp16 else x

    viewproj = vertex.mat4_mul(params.proj, params.view)
    fb = q(_background(params, hp, wp, height) if bg_fb is None else bg_fb)

    aux = {}
    to = buffers.opaque_tri_vidx.shape[0]
    tt = buffers.transp_tri_vidx.shape[0]
    if tt > 0 and transp_textured:
        raise NotImplementedError(
            "textured transparency (the depth-peel loop, kernel 2.3) is not "
            "ported yet: ROADMAP.md Queue 1 item 7")

    # frustum cull (opaque only — transparent surfaces are submitted
    # unculled, vk_engine.cpp:1459-1465)
    vis = vertex.draw_visibility(viewproj, buffers.draw_model,
                                 buffers.draw_bounds_origin,
                                 buffers.draw_bounds_extents)
    aux["visible_opaque_draws"] = (vis & buffers.draw_opaque_mask).sum(dtype=torch.int32)
    z = torch.full((hp, wp), raster.DEPTH_CLEAR, dtype=torch.float32, device=dev)
    sun = params.sun_dir[:3]

    rows_t = t_aabb = t_valid = None
    if to > 0:
        if tt > 0:
            # one setup over opaque ++ transparent (the plane math is per
            # triangle, so slices equal two separate calls); transparent
            # draws ride the visibility as always-true
            corners = vertex.concat_corners(buffers.opaque_corners,
                                            buffers.transp_corners)
            rows_all, aabb_all, valid_all = vertex.triangle_setup_rows(
                corners,
                torch.cat([buffers.opaque_tri_draw, buffers.transp_tri_draw]),
                torch.cat([buffers.opaque_tri_valid, buffers.transp_tri_valid]),
                buffers.draw_model, vis | ~buffers.draw_opaque_mask, viewproj,
                width, height, sun_dir=sun)
            rows, o_aabb, o_valid = rows_all[:to], aabb_all[:to], valid_all[:to]
            rows_t, t_aabb, t_valid = rows_all[to:], aabb_all[to:], valid_all[to:]
        else:
            rows, o_aabb, o_valid = vertex.triangle_setup_rows(
                buffers.opaque_corners, buffers.opaque_tri_draw,
                buffers.opaque_tri_valid, buffers.draw_model, vis, viewproj,
                width, height, sun_dir=sun)
        rows_s, bins, counts = _binned(o_aabb, o_valid, rows, tiles)
        z, tid, attrs, meta, inv = raster.rasterize_fused(rows_s, bins, counts, **tiles)
        valid = tid >= 0
        shaded = shade.shade_fused(attrs, meta, inv, buffers.atlas,
                                   params.ambient[:3], params.sun_color[3],
                                   trilinear=trilinear, pot=pot)
        rgb = torch.where(valid[None], shaded, fb[:3])
        alpha = torch.where(valid, _f32(1.0, dev), fb[3])
        fb = q(torch.cat([rgb, alpha[None]]))
        aux["opaque_triangles"] = o_valid.sum(dtype=torch.int32)

    if tt > 0:
        if rows_t is None:   # no opaque triangles: no combined setup ran
            rows_t, t_aabb, t_valid = vertex.triangle_setup_rows(
                buffers.transp_corners, buffers.transp_tri_draw,
                buffers.transp_tri_valid, buffers.draw_model,
                torch.ones_like(vis), viewproj, width, height, sun_dir=sun)
        # mesh.frag writes alpha = 1 (shaders/mesh.frag:18), so the
        # additive blend is an order-independent sum over all transparent
        # fragments: one accumulation pass shades every layer
        rows_ts, bins_t, counts_t = _binned(t_aabb, t_valid, rows_t, tiles)
        light = torch.cat([params.sun_dir[:3], params.sun_color[3:4],
                           params.ambient[:3],
                           torch.zeros(1, dtype=torch.float32, device=dev)])
        acc, cnt = raster.rasterize_accum(rows_ts, bins_t, counts_t, z,
                                          light.contiguous(), **tiles)
        covered = cnt > 0
        # the first blended fragment scales dst by dstAlpha
        # (vk_pipelines.cpp:161-162); dst.a == 1 afterwards
        rgb = torch.where(covered[None], acc + fb[:3] * fb[3][None], fb[:3])
        alpha = torch.where(covered, _f32(1.0, dev), fb[3])
        fb = q(torch.cat([rgb, alpha[None]]))
        aux["transparent_layers"] = cnt.max()

    return to_packed_u32(fb, width=width, height=height), aux


@torch.no_grad()
def render_frames(buffers: SceneBuffers, params_list: List[FrameParams], **kw):
    """Render a sequence of frames. The background depends only on the
    background params, which a batch holds constant, so it is computed once.
    Returns (last frame image, (F,) int32 per-frame checksums)."""
    bg = background_fb(params_list[0], width=kw["width"], height=kw["height"],
                       tile_h=kw.get("tile_h", 32), tile_w=kw.get("tile_w", 128))
    img, sums = None, []
    for p in params_list:
        img, _aux = render_frame(buffers, p, bg_fb=bg, **kw)
        sums.append((img[::191, ::127] & 0xFF).sum(dtype=torch.int32))
    return img, torch.stack(sums)
