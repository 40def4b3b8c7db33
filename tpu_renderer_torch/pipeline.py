"""The frame function — everything the reference does between fence-wait and
present (vk_engine.cpp:1218-1339), as plain PyTorch around the CUDA raster
kernels:

    background compute pass     (draw_background, vk_engine.cpp:1341-1355:
       kernel 2.9 or 2.10, background.gradient / background.sky)
    -> per-draw frustum cull    (is_visible, vk_engine.cpp:56-86)
    -> vertex transform + setup (mesh.vert + primitive assembly)
    -> opaque pass, fused (default): spatial sort + dense tile bins, the
       fused raster (kernel 2.1, raster.rasterize_fused), deferred shading
       (mesh.frag) from its interpolated planes with the composite as its
       epilogue (kernel 2.12, shade.shade_fused);
       or deferred (fused=False): capped chunk bins refined to triangles,
       the visibility raster (kernel 2.4, raster.rasterize), shading by a
       per-pixel fat-row gather
    -> transparent pass (the additive blend, vk_engine.cpp:1673-1676):
       untextured on the fused path, one accumulation (kernel 2.2,
       raster.rasterize_accum); otherwise a depth peel in submission order,
       one layer at a time until no pixel finds another (kernel 2.3,
       raster.rasterize_peel_fused, each layer shaded and blended by 2.12;
       or 2.5, raster.rasterize_peel)
    -> upscale blit when the render scale is not 1 (linear_blit)
    -> unorm8 convert           (swapchain blit, vk_images.cpp:33-64)

The framebuffer is R16G16B16A16_SFLOAT in the reference (vk_engine.cpp:749):
every composite rounds through fp16, exactly where the JAX package's q()
runs. Everything runs on the device the scene buffers live on.

On the card a steady frame is one device program, as the JAX package's
jax.jit(render_frame) is: frame_graph.FrameGraph captures the frame once per
key of statics as a CUDA graph, with the peel loop inside it as a WHILE node
(kernels/conditional.py: lax.while_loop's counterpart), and replays it;
render_frames, given the Engine's render_fn(), replays one captured frame
per FrameParams (lax.scan's counterpart); a mesh over nccl is captured the
same way (parallel/multichip.py). The CPU, a mesh over gloo and the eager()
block draw op by op; the peel loop is the same, its tests read on the host.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from tpu_renderer_torch.kernels import background, conditional, raster, shade, vertex
from tpu_renderer_torch.kernels.common import pad_extent
from tpu_renderer_torch.present import to_packed_u32
from tpu_renderer_torch.resources import TextureAtlas
from tpu_renderer_torch.utils.profiling import device_frame, device_span, frame_number, span


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


def _background(params: FrameParams, hp: int, wp: int, height: int,
                tile_h: int = 32, tile_w: int = 128, effect: Optional[int] = None):
    """Background compute pass (the color attachment then LOADs, not clears:
    vk_initializers.cpp:125): kernel 2.9 (effect 0, background.gradient) or
    2.10 (effect 1, background.sky). effect: the selector where the caller
    knows it on the host; otherwise params.bg_effect is read back (a sync)."""
    if effect is None:
        effect = int(params.bg_effect)
    extent = dict(height=height, width_pad=wp, height_pad=hp, tile_h=tile_h,
                  tile_w=tile_w)
    if min(max(effect, 0), 1) == 0:
        return background.gradient(params.bg_data1.contiguous(),
                                   params.bg_data2.contiguous(), **extent)
    return background.sky(params.bg_data1.contiguous(), **extent)


@torch.no_grad()
def background_fb(params: FrameParams, *, width: int, height: int,
                  tile_h: int = 32, tile_w: int = 128, effect: Optional[int] = None):
    """The background pass alone, at the padded draw extent. A pure function
    of the background params, so the Engine caches it across frames."""
    wp, hp = pad_extent(width, height, tile_h, tile_w)
    return _background(params, hp, wp, height, tile_h, tile_w, effect)


def _triangle_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) f32 weights of a linear resize along one axis, as
    jax.image.resize(method="linear") builds them (jax._src.image.scale.
    compute_weight_mat): half-pixel centres, the triangle kernel widened by
    the scale when the axis shrinks (antialias), each column normalised to
    sum 1, so the edges renormalise."""
    f = np.float32
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = f(max(inv_scale, 1.0))
    sample = (np.arange(out_size, dtype=f) + f(0.5)) * f(inv_scale) - f(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f)[:, None]) / kernel_scale
    w = np.maximum(f(0.0), f(1.0) - x)
    total = w.sum(axis=0, keepdims=True, dtype=f)
    w = np.where(np.abs(total) > f(1000.0 * np.finfo(f).eps),
                 w / np.where(total != 0, total, f(1.0)), f(0.0))
    inside = (sample >= f(-0.5)) & (sample <= f(in_size - 0.5))
    return np.where(inside[None, :], w, f(0.0)).astype(f)


@functools.lru_cache(maxsize=4)
def _blit_taps(in_size: int, out_size: int, device):
    """The non-zero taps of _triangle_weights, column by column: (idx (K,
    out_size) i64 source indices, w (K, out_size) f32 weights), K the widest
    column's count (2 when the axis grows). A tap past the column's support
    has weight 0. A few KB an axis; read-only."""
    dense = _triangle_weights(in_size, out_size)
    live = dense != 0
    first = np.argmax(live, axis=0)
    k = max(int(live.sum(axis=0).max()), 1)
    idx = first[None, :] + np.arange(k)[:, None]
    w = np.take_along_axis(dense, np.minimum(idx, in_size - 1), axis=0)
    w = np.where(idx < in_size, w, np.float32(0.0))
    return (torch.as_tensor(np.minimum(idx, in_size - 1), device=device),
            torch.as_tensor(w.astype(np.float32), device=device))


def _resize_axis(x, out_size: int, dim: int):
    """Linear resize of x along dim (-1 or -2): each output sample is the
    sum of its taps in ascending source order."""
    idx, w = _blit_taps(x.shape[dim], out_size, x.device)
    out = None
    for k in range(idx.shape[0]):
        wk = w[k] if dim == -1 else w[k][:, None]
        term = x.index_select(dim, idx[k]) * wk
        out = term if out is None else out + term
    return out


def linear_blit(fb, *, width: int, height: int, out_width: int, out_height: int):
    """The upscale blit (vkCmdBlitImage2 with VK_FILTER_LINEAR,
    vk_images.cpp:33-64): the (4, height, width) crop of the framebuffer
    resampled to (4, out_height, out_width) with the weights of
    jax.image.resize(method="linear"). The cheaper axis order goes first,
    which is also the order the reference's einsum contracts in."""
    crop = fb[:, :height, :width]
    columns_first = (height * width * out_width + height * out_width * out_height
                     <= height * width * out_height + out_height * width * out_width)
    if columns_first:
        return _resize_axis(_resize_axis(crop, out_width, -1), out_height, -2)
    return _resize_axis(_resize_axis(crop, out_height, -2), out_width, -1)


def _bins(aabb, valid, tiles):
    """Chunk and group boxes -> dense tile bins, triangles in the order
    given."""
    caabb, cvalid = raster.chunk_aabbs(aabb, valid)
    gaabb, gvalid = raster.group_aabbs(aabb, valid)
    return raster.bin_triangles_full(caabb, cvalid, gaabb, gvalid, **tiles)


def _binned(aabb, valid, rows, tiles):
    """Spatial sort -> chunk/group boxes -> dense tile bins."""
    aabb_s, valid_s, rows_s = raster.spatial_sort(aabb, valid, rows)
    bins, counts = _bins(aabb_s, valid_s, tiles)
    return rows_s.contiguous(), bins, counts


def _deferred_setup(corners, tri_draw, tri_valid, buffers, vis, viewproj,
                    width, height, sun):
    """The deferred path's setup: packed rows, boxes, validity and the fat
    rows its shading gathers."""
    setup = vertex.triangle_setup_c(corners, tri_draw, tri_valid,
                                    buffers.draw_model, vis, viewproj, width,
                                    height, sun_dir=sun)
    rows = shade.build_shade_rows(setup.packed, setup.attrs, setup.aabb,
                                  corners.meta6)
    return setup, rows


def _composite(fb, found, src, q):
    """Additive blend (vk_pipelines.cpp:157-167, shade.composite): rgb = src
    + dst * dstAlpha and alpha = 1 where found, then the fp16 write."""
    return q(shade.composite(fb, found, src, "add"))


class _Peel(NamedTuple):
    """What every layer of the transparent peel reads."""

    fused: bool                # kernel 2.3 over fat rows, or 2.5 over packed rows
    rows: torch.Tensor         # (Tt, 48) fat rows: the peel's (fused) or shading's
    packed: Optional[torch.Tensor]  # (Tt, 16) setup rows (deferred)
    bins: torch.Tensor
    counts: torch.Tensor
    z: torch.Tensor            # (Hp, Wp) opaque depth
    tiles: dict
    look: dict                 # shading statics and uniforms
    textured: bool
    fp16: bool                 # the framebuffer's writes round to fp16
    q: Callable


def _peel_layer(p: _Peel, fb, last):
    """One transparent layer past `last` (per pixel the next triangle id in
    submission order, ID_INF where none): kernel 2.3 or 2.5. Returns (found
    (Hp, Wp) bool, blend), where blend() shades the layer, composites it over
    fb in place and returns `last` for the next layer. On the fused path the
    composite is the shading's epilogue (shade.shade_fused, kernel 2.12 on
    the card)."""
    if p.fused:
        layer, attrs, meta, inv = raster.rasterize_peel_fused(
            p.rows, p.bins, p.counts, p.z, last, **p.tiles)
    else:
        layer = raster.rasterize_peel(p.packed, p.bins, p.counts, p.z, last, **p.tiles)
    found = layer < raster.ID_INF

    def blend():
        with device_span("shade"):
            if p.fused:
                shade.shade_fused(attrs, meta, inv, textured=p.textured, fb=fb, hit=found,
                                  blend="add", fp16=p.fp16, out=fb, **p.look)
            else:
                src = shade.blend_layer(fb, torch.where(found, layer, raster.NO_TRI),
                                        p.rows, textured=p.textured, **p.look)
        if not p.fused:
            with device_span("composite"):
                fb.copy_(p.q(src))
        return torch.where(found, layer, raster.ID_INF)

    return found, blend


def _peel_on_device(p: _Peel, fb, last, layers, limit: int) -> None:
    """Peel until a layer finds nothing (that empty layer is not shaded: it
    would leave fb unchanged), the tests on the device: a WHILE node around
    an IF node when a FrameGraph captures it (no host read, as many passes
    as the frame needs); elsewhere the host reads each test (two a pass).
    fb, last and layers are updated in place. Every pass raises `last` at
    each pixel it shades, so a frame of `limit` transparent triangles shades
    at most `limit` layers; the loop also stops past that, which only a
    faulty pass could reach (it keeps such a loop from running on the card
    forever). Each pass is a device span `peel_pass` whose instance is the
    layers peeled before it, read on the card."""

    def one_pass():
        with device_span("peel_pass", instance=layers):
            with device_span("raster"):
                found, blend = _peel_layer(p, fb, last)
            more = found.any()

            def keep():
                last.copy_(blend())
                layers.add_(1)

            conditional.run_if(more, keep)
            return more & (layers <= limit)

    conditional.run_while(torch.ones((), dtype=torch.bool, device=fb.device), one_pass)


@torch.no_grad()
def render_frame(buffers: SceneBuffers, params: FrameParams, *,
                 width: int, height: int, tile_h: int = 32, tile_w: int = 128,
                 bin_cap: int = 512, tri_cap: int = 1024, fp16: bool = True,
                 transp_textured: bool = True, fused: bool = True,
                 trilinear: bool = True, pot: bool = False,
                 out_width: Optional[int] = None, out_height: Optional[int] = None,
                 bg_fb=None):
    """Render one frame. Returns ((H, W) int32 packed-RGBA image — see
    present.unpack_u8 — and an aux dict of device scalars).

    out_width/out_height: when set and different from (width, height), the
    frame renders at (width, height) and a linear blit resamples it to the
    output extent (the reference's _render_scale path made live,
    vk_engine.cpp:1220-1222, 1251-1252).

    fused: the fused raster path (uncapped dense bins) or the deferred one,
    whose bins hold at most bin_cap chunks and tri_cap triangles a tile
    (aux's bin_overflow* counters count what they dropped).
    transp_textured: static, does any transparent material bind a texture?
    If not, the fused path sums the transparent layers in one pass;
    otherwise they are peeled one by one (the deferred path always peels).
    bg_fb: optional precomputed (4, Hp, Wp) background (background_fb)."""
    if (out_width is None) != (out_height is None):
        raise ValueError("out_width and out_height must be set together")
    wp, hp = pad_extent(width, height, tile_h, tile_w)
    tiles = dict(tiles_x=wp // tile_w, tiles_y=hp // tile_h,
                 tile_w=tile_w, tile_h=tile_h)
    dev = buffers.draw_model.device

    def q(x):
        # the draw image is R16G16B16A16_SFLOAT: writes round to fp16
        return x.half().float() if fp16 else x

    # the frame's device spans (utils/profiling.py, while tracing): cull,
    # setup, bins, raster, shade, composite (where a composite runs apart
    # from the shading: the accumulation's, the deferred path's),
    # transparent (the accumulation), peel (its passes), present
    with device_frame(dev):
        viewproj = vertex.mat4_mul(params.proj, params.view)
        fb = q(_background(params, hp, wp, height, tile_h, tile_w) if bg_fb is None
               else bg_fb)

        aux = {}
        to = buffers.opaque_tri_vidx.shape[0]
        tt = buffers.transp_tri_vidx.shape[0]
        no_overflow = torch.zeros((), dtype=torch.int32, device=dev)
        look = dict(atlas=buffers.atlas, ambient_rgb=params.ambient[:3],
                    sun_power=params.sun_color[3], trilinear=trilinear, pot=pot)

        # frustum cull (opaque only — transparent surfaces are submitted
        # unculled, vk_engine.cpp:1459-1465)
        with device_span("cull"):
            vis = vertex.draw_visibility(viewproj, buffers.draw_model,
                                         buffers.draw_bounds_origin,
                                         buffers.draw_bounds_extents)
            aux["visible_opaque_draws"] = (vis & buffers.draw_opaque_mask).sum(
                dtype=torch.int32)
        z = torch.full((hp, wp), raster.DEPTH_CLEAR, dtype=torch.float32, device=dev)
        sun = params.sun_dir[:3]

        rows_t = t_aabb = t_valid = None
        if to > 0 and fused:
            with device_span("setup"):
                if tt > 0:
                    # one setup over opaque ++ transparent (the plane math is
                    # per triangle, so slices equal two separate calls);
                    # transparent draws ride the visibility as always-true
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
            with device_span("bins"):
                rows_s, bins, counts = _binned(o_aabb, o_valid, rows, tiles)
            with device_span("raster"):
                z, tid, attrs, meta, inv = raster.rasterize_fused(rows_s, bins, counts,
                                                                  **tiles)
            with device_span("shade"):
                # the opaque composite is the shading's epilogue
                fb = shade.shade_fused(attrs, meta, inv, fb=fb, hit=tid >= 0,
                                       blend="replace", fp16=fp16, **look)
            overflow_c = overflow_t = no_overflow
        elif to > 0:
            with device_span("setup"):
                setup, rows = _deferred_setup(
                    buffers.opaque_corners, buffers.opaque_tri_draw,
                    buffers.opaque_tri_valid, buffers, vis, viewproj, width, height, sun)
            o_valid = setup.valid
            with device_span("bins"):
                caabb, cvalid = raster.chunk_aabbs(setup.aabb, setup.valid)
                cbins, ccounts, overflow_c = raster.bin_triangles(
                    caabb, cvalid, bin_cap=bin_cap, **tiles)
                bins, counts, overflow_t = raster.refine_bins(
                    cbins, setup.aabb, tri_cap=tri_cap, **tiles)
            with device_span("raster"):
                z, tid = raster.rasterize(setup.packed, bins, counts, **tiles)
            with device_span("shade"):
                fb = shade.shade(tid, rows, background=fb, **look)
            with device_span("composite"):
                fb = q(fb)
        if to > 0:
            aux["bin_overflow"] = overflow_c
            aux["bin_overflow_tris"] = overflow_t
            aux["opaque_triangles"] = o_valid.sum(dtype=torch.int32)

        if tt > 0:
            overflow_tc = overflow_tt = no_overflow
            if not fused:
                with device_span("setup"):
                    setup_t, rows_t = _deferred_setup(
                        buffers.transp_corners, buffers.transp_tri_draw,
                        buffers.transp_tri_valid, buffers, torch.ones_like(vis),
                        viewproj, width, height, sun)
                t_aabb, t_valid = setup_t.aabb, setup_t.valid
            elif rows_t is None:   # no opaque triangles: no combined setup ran
                with device_span("setup"):
                    rows_t, t_aabb, t_valid = vertex.triangle_setup_rows(
                        buffers.transp_corners, buffers.transp_tri_draw,
                        buffers.transp_tri_valid, buffers.draw_model,
                        torch.ones_like(vis), viewproj, width, height, sun_dir=sun)

            if fused and not transp_textured:
                # mesh.frag writes alpha = 1 (shaders/mesh.frag:18), so the
                # additive blend is an order-independent sum over all
                # transparent fragments: one accumulation pass shades every
                # layer
                with device_span("transparent"):
                    with device_span("bins"):
                        rows_ts, bins_t, counts_t = _binned(t_aabb, t_valid, rows_t, tiles)
                    with device_span("raster"):
                        light = torch.cat([params.sun_dir[:3], params.sun_color[3:4],
                                           params.ambient[:3],
                                           torch.zeros(1, dtype=torch.float32, device=dev)])
                        acc, cnt = raster.rasterize_accum(rows_ts, bins_t, counts_t, z,
                                                          light.contiguous(), **tiles)
                    with device_span("composite"):
                        fb = _composite(fb, cnt > 0, acc, q)
                    layers = cnt.max()
            else:
                # peel one layer at a time in submission order, until no
                # pixel finds another fragment. The bins keep submission
                # order (no spatial sort): the triangle id is the peel order.
                with device_span("bins"):
                    if fused:
                        bins_t, counts_t = _bins(t_aabb, t_valid, tiles)
                    else:
                        caabb_t, cvalid_t = raster.chunk_aabbs(t_aabb, t_valid)
                        cbins_t, ccounts_t, overflow_tc = raster.bin_triangles(
                            caabb_t, cvalid_t,
                            bin_cap=min(bin_cap, max(tt // raster.CHUNK, 1)), **tiles)
                        if tt <= 4096:
                            # small sets skip the refine: the peel evaluates
                            # the few extra chunk members instead
                            bins_t, counts_t = raster.expand_bins(cbins_t, ccounts_t)
                        else:
                            bins_t, counts_t, overflow_tt = raster.refine_bins(
                                cbins_t, t_aabb, tri_cap=tri_cap, **tiles)
                peel = _Peel(fused=fused, rows=rows_t,
                             packed=None if fused else setup_t.packed,
                             bins=bins_t, counts=counts_t, z=z, tiles=tiles, look=look,
                             textured=transp_textured, fp16=fp16, q=q)
                last = torch.full((hp, wp), -1, dtype=torch.int32, device=dev)
                layers = torch.zeros((), dtype=torch.int32, device=dev)
                if fb is bg_fb:   # updated in place: never the caller's buffer
                    fb = fb.clone()
                with device_span("peel"):
                    _peel_on_device(peel, fb, last, layers, limit=tt)
            # chunk and triangle overflow apart, so the engine widens only
            # the capacity that overflowed
            aux["bin_overflow_transparent"] = overflow_tc
            aux["bin_overflow_transparent_tris"] = overflow_tt
            aux["transparent_layers"] = layers

        with device_span("present"):
            if out_width is not None and (out_width, out_height) != (width, height):
                up = linear_blit(fb, width=width, height=height, out_width=out_width,
                                 out_height=out_height)
                return to_packed_u32(up, width=out_width, height=out_height), aux
            return to_packed_u32(fb, width=width, height=height), aux


# -- eager or graphed (frame_graph.py: jax.jit's counterpart) -----------------

_mode = threading.local()


@contextlib.contextmanager
def eager():
    """jax.disable_jit()'s counterpart: inside the block the Engine (so
    render_frames through its render_fn()) draws every frame op by op on the
    card too, capturing and replaying no graph (utils.profiling.debug_mode enters it: its checks
    need each operation dispatched). Blocks nest."""
    _mode.eager = getattr(_mode, "eager", 0) + 1
    try:
        yield
    finally:
        _mode.eager -= 1


def graphed(device) -> bool:
    """Does a frame on `device` go through a FrameGraph here: a CUDA device,
    outside eager()?"""
    return torch.device(device).type == "cuda" and getattr(_mode, "eager", 0) == 0


@torch.no_grad()
def render_frames(buffers: SceneBuffers, params_list: List[FrameParams],
                  frame: Callable = render_frame, **kw):
    """Render a sequence of frames, each by frame(buffers, params, bg_fb=...,
    **kw) (render_frame's signature; the Engine's render_fn() replays its
    frame graph on the card: the port's lax.scan). The background depends
    only on the background params, which a batch holds constant, so it is
    computed once. Returns (last frame image, (F,) int32 per-frame
    checksums). Host spans, while tracing: render_frames, and inside it
    background, render_frame (each frame: its draw and its checksum) and
    checksums."""
    with span("render_frames"):
        with span("background"):
            bg = background_fb(params_list[0], width=kw["width"], height=kw["height"],
                               tile_h=kw.get("tile_h", 32), tile_w=kw.get("tile_w", 128))
        img, sums = None, []
        for p in params_list:
            with span("render_frame", frame=frame_number() + 1):
                img, _aux = frame(buffers, p, bg_fb=bg, **kw)
                sums.append((img[::191, ::127] & 0xFF).sum(dtype=torch.int32))
        with span("checksums"):
            return img, torch.stack(sums)
