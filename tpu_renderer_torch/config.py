"""Central configuration for the renderer.

The reference scatters every knob as a compile-time constant (window extent
1700x900 `vk_engine.h:219`, FRAME_OVERLAP=3 `vk_engine.h:77`, camera speed
`camera.h:7`, FOV/near/far `vk_engine.cpp:1492-1493`, lighting
`vk_engine.cpp:1496-1498`, background defaults `vk_engine.cpp:977-984`).
Here they all live in one dataclass.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RendererConfig:
    # --- Framebuffer / window (vk_engine.h:219: 1700x900 default window) ---
    width: int = 1700
    height: int = 900

    # --- Projection (vk_engine.cpp:1492-1494) ---
    # glm::perspective(radians(70), w/h, 10000, 0.1) with GLM_FORCE_DEPTH_ZERO_TO_ONE
    # and proj[1][1] *= -1. Near/far are intentionally swapped: reversed-Z
    # (depth 1.0 at distance 0.1, depth 0.0 at distance 10000).
    fov_y_deg: float = 70.0
    z_near: float = 10000.0
    z_far: float = 0.1

    # --- Depth attachment (vk_initializers.cpp:144, vk_engine.cpp:1659) ---
    # Cleared to 0.0 every frame; compare op GREATER_OR_EQUAL.
    depth_clear: float = 0.0

    # --- Camera (vk_engine.cpp:203-210, camera.h:7) ---
    camera_position: Tuple[float, float, float] = (30.0, 0.0, -85.0)
    camera_speed: float = 0.8

    # --- Lighting (vk_engine.cpp:1496-1498) ---
    ambient_color: Tuple[float, float, float, float] = (0.1, 0.1, 0.1, 0.1)
    sunlight_direction: Tuple[float, float, float, float] = (0.0, 1.0, 0.5, 1.0)
    sunlight_color: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)

    # --- Background compute pass (vk_engine.cpp:933-1004) ---
    # effect 0 = "gradient" (gradient_color.comp; data1=top color, data2=bottom
    # color; defaults (1,1,1,1)/(1,1,1,1) => solid white, vk_engine.cpp:977-978)
    # effect 1 = "sky" (sky.comp; data1.rgb = sky color, data1.w = star
    # threshold; default (0.1,0.2,0.4,0.97), vk_engine.cpp:984)
    background_effect: int = 0
    gradient_data1: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    gradient_data2: Tuple[float, float, float, float] = (1.0, 1.0, 1.0, 1.0)
    sky_data1: Tuple[float, float, float, float] = (0.1, 0.2, 0.4, 0.97)

    # --- TPU rasterizer knobs (no reference counterpart; ours) ---
    # Framebuffer tile size for the Pallas raster kernel. Last dim 128 matches
    # the VPU lane width; 32 sublanes keeps edge-function arrays register-friendly.
    tile_h: int = 32
    tile_w: int = 128
    # Framebuffer storage dtype. The reference draw image is
    # R16G16B16A16_SFLOAT (vk_engine.cpp:749); storing fp16 reproduces its
    # quantization. Depth is D32_SFLOAT (vk_engine.cpp:774) => f32.
    framebuffer_fp16: bool = True

    # --- Raster path selection (ours) ---
    # True (default): fused chunk-streaming slab raster — uncapped, nothing
    # can overflow. False: the deferred (gather-based) path with capped
    # bins + reactive cap escalation; kept as an A/B oracle and for the
    # multichip composite comparison.
    fused: bool = True
    # Dense-bin memory guard: the fused path's uncapped bins are
    # O(n_tiles x n_chunks) i32 (+ i32 sort keys past 32k chunks) —
    # ~24 MB per million triangles at 1080p/32x128 tiles (docs/PERF.md
    # "Dense-bin memory envelope"). Scenes whose triangle count exceeds
    # dense_bin_max_chunks * raster.CHUNK (default ~1M tris) auto-fall
    # back to the capped deferred path (Engine._compute_caps), whose
    # memory is bounded by bin_cap/tri_cap + reactive escalation. 32768
    # is also the i16 sort-key envelope: beyond it the row-wise bin sort
    # pays double-width keys anyway (raster._dense_sorted_hits).
    dense_bin_max_chunks: int = 32768

    # --- Multi-chip scale-out (no reference counterpart; SURVEY §2.4) ---
    # (rows, tri): shard the framebuffer row bands over 'rows' ranks and
    # the triangle list over 'tri' ranks (tpu_renderer_torch/parallel/
    # multichip.py), one process a rank. None = one device. Engine.init
    # needs an initialised process group of rows*tri ranks
    # (multichip.launch or torchrun); ranks share a card where there are
    # fewer cards than ranks.
    multichip: Tuple[int, int] | None = None

    # --- Raster kernel knobs (ours; see kernels/raster.py) ---
    # Production values, applied process-wide by Engine via
    # raster.configure(). The RASTER_CHUNK / RASTER_GROUP / RASTER_NBUF /
    # RASTER_SORT env vars OVERRIDE these for A/B measurement and the CPU
    # test tier (tests/conftest.py pins RASTER_CHUNK=8 there). The knobs
    # compile into kernel unrolls and HBM chunk-block shapes, so mixing two
    # values of one knob in a process is unsupported.
    # raster_chunk: triangles per binning chunk / DMA block (swept: 32 best
    # on both bench scenes — raster.py CHUNK comment).
    raster_chunk: int = 32
    # raster_group: triangles per gmask skip group (the per-entry dead-eval
    # skip granularity; chunk/group <= 8 groups must hold).
    raster_group: int = 8
    # raster_nbuf: chunk-stream scratch slots (power of 2; NBUF-1 DMA copies
    # in flight — swept 2/4/8, 4 optimal).
    raster_nbuf: int = 4
    # raster_sort: screen-space spatial sort key (hilbert | morton | band |
    # bandserp; hilbert measured best — docs/PERF.md "key evolution").
    raster_sort: str = "hilbert"

    # --- Auto quality (ours) ---
    # target_fps: when set, the engine auto-engages the render-scale lever
    # for scenes the measured per-pixel cost model predicts are over budget
    # at the native extent — the product answer for stock glTF content,
    # whose DEFAULT samplers are trilinear (the reference loader's
    # extract_mipmap_mode falls back to LINEAR, vk_loader.cpp:43-54) and
    # therefore pay both mip-tap gathers per pixel (the measured 2-tap
    # wall, docs/PERF.md). The engine picks the LARGEST scale in
    # [auto_scale_min, render_scale] predicted to hit target_fps
    # (Engine._pick_auto_scale); scenes already under budget render at the
    # native extent unchanged. None = always render at render_scale.
    target_fps: float | None = None
    # Floor for the auto-picked scale (0.5 = quarter pixel cost; below that
    # the upscale blit visibly softens 1080p output).
    auto_scale_min: float = 0.5

    # --- Render scale (vk_engine.cpp:1220-1222) ---
    # The reference computes _draw_extent from _render_scale and then
    # overwrites it (dead code, vk_engine.cpp:1251-1252); here the knob is
    # LIVE: geometry renders at round(extent * render_scale) and the frame
    # upscales to the window extent with a linear blit
    # (vkCmdBlitImage2 VK_FILTER_LINEAR semantics, vk_images.cpp:33-64).
    # 0.5 shades ~4x fewer pixels — the practical interactive-speed lever;
    # > 1.0 is supersampling (SSAA): draw at NxN, linear-blit down.
    render_scale: float = 1.0

    @property
    def aspect(self) -> float:
        return float(self.width) / float(self.height)

    def with_extent(self, width: int, height: int) -> "RendererConfig":
        """Resize path (vk_engine.cpp:1520-1534): re-jit at the new extent."""
        return dataclasses.replace(self, width=width, height=height)
